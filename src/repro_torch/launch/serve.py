"""Serving entry point: continuous-batching engine + per-request metrics (port of
``launch/serve.py`` for the token-prompt decoder LMs).

    python -m repro_torch.launch.serve --arch yi-6b [--reduced] [--device cpu]

Random weights from seed 0, random prompts from a ``torch.Generator`` seeded
1 (ids 1..vocab-1, off the default EOS id 0), as the JAX CLI seeds them.  It runs on
the GPU unless ``--device cpu`` is given, and raises without a GPU.  The
JAX CLI's ``--obs-dir`` is not ported (obs is not), nor its fixed-wave path
for the encoder-frontend families (the registry refuses those archs).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.device import resolve_device
from repro_torch.serving import Engine, aggregate_metrics


def make_prompts(n: int, length: int, vocab: int, seed: int, device) -> list[list[int]]:
    """``n`` random prompts of ``length`` ids in [1, vocab), from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(1, vocab, (n, length), generator=gen, device=device)
    return ids.tolist()


def submit_all(engine: Engine, prompts: list[list[int]], *, max_new: int,
               slo_ttft_ms=None) -> None:
    for prompt in prompts:
        rid, admitted = engine.submit(prompt, max_new=max_new, slo_ttft_ms=slo_ttft_ms)
        if not admitted:
            print(f"request {rid} shed at admission (projected TTFT > SLO)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--eos", type=int, default=0)
    ap.add_argument("--slo-ttft-ms", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab, 1, device)
    engine = Engine(model, params, n_slots=args.slots, page_size=args.page,
                    max_len=args.prompt_len + args.max_new, eos_id=args.eos)
    submit_all(engine, prompts, max_new=args.max_new, slo_ttft_ms=args.slo_ttft_ms)
    completions = engine.drain()
    m = aggregate_metrics(completions)
    print(
        f"{int(m['requests'])} requests ({int(m['shed'])} shed): {int(m['tokens'])} tokens, "
        f"{m['tok_per_s']:.1f} tok/s | TTFT p50 {m['ttft_p50_ms']:.1f}ms "
        f"p95 {m['ttft_p95_ms']:.1f}ms | per-token p50 {m['per_token_p50_ms']:.1f}ms "
        f"p95 {m['per_token_p95_ms']:.1f}ms"
    )
    for rid in sorted(completions)[:2]:
        c = completions[rid]
        print(f"request {rid} [{c.finish}]: {c.tokens}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
