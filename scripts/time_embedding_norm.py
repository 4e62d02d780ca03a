#!/usr/bin/env python3
"""Time the port's embedding norm kernel on one GPU in this checkout and,
with ``--src``, in another one (e.g. a ``git archive`` of a parent commit),
so that both are compared within one call.

    python3 scripts/time_embedding_norm.py                    # this checkout
    python3 scripts/time_embedding_norm.py --src OTHER/src    # another checkout's port

Prints the card's name and power limit, then one line per case: the
kernel's mean CUDA-event ms over ``--iters`` back-to-back calls, its
profiler device ms, its reading against the plain version (max |kernel -
plain| / max |plain|) and whether two calls are bit-identical, then each
device kernel's share of the device ms (the sort, the segment pass, the
finish) and the time of a plain streaming read of g (``g.sum``).  The
shapes and ids are chip_smoke.py's: the ViT-Base step's pos_embed tap
(fp32 g, as steps before the stored dtype passed it, and bf16) and its
``EMBED_LM`` shapes, ids drawn by its ``_embedding_ids`` from seed 0.
Built kernels go to the given checkout's build/kernels.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VIT = [((32, 196, 768, 196), "positions", dtype) for dtype in ("float32", "bfloat16")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_embedding_norm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import EMBED_LM, _embedding_ids

    sys.path.insert(0, args.src)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ghost_norm import ghost_norm as gn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    print(f"timing {Path(gn.__file__).resolve()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = VIT + [(shape, kind, "bfloat16") for shape, kind in EMBED_LM]
    for (n, t, p, vocab), kind, dtype in cases:
        ids = _embedding_ids(n, t, vocab, kind, gen).contiguous()
        g = torch.randn(n, t, p, generator=gen, device="cuda").to(getattr(torch, dtype))

        def call():
            return gn.embedding_ghost_norm_sq_cuda(ids, g)

        got = call()
        want = gn.embedding_ghost_norm_sq_plain(ids, g)
        rel = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        same = bool(torch.equal(got, call()))
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.iters
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kernels)
        device = f"{us / 1e3 / args.iters:.4f}" if us > 0 else "not measured"
        print(f"({n}, {t}, {p}, {vocab}) {kind} ids, {dtype} g: ms={ms:.4f} "
              f"device={device} rel_err={rel:.2e} deterministic={same}", flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
            print(f"    {e.self_device_time_total / 1e3 / args.iters:.4f} ms {e.key[:90]}")
        # a plain streaming read of the same g, for the bytes' practical rate
        start.record()
        for _ in range(args.iters):
            g.sum(dtype=torch.float32)
        end.record()
        torch.cuda.synchronize()
        read_ms = start.elapsed_time(end) / args.iters
        print(f"    g.sum(dtype=float32), a streaming read of g: {read_ms:.4f} ms "
              f"({g.numel() * g.element_size() / read_ms / 1e9:.2f} TB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
