"""Continuous-batching serving demo on the port's ``repro_torch.serving.Engine``
(the counterpart of ``examples/serve_batched.py``).

Submits a mixed-length request stream (some with TTFT SLOs), drains the
engine, and prints per-request latency plus the aggregate row.  A finished
slot is recycled to the next queued request on the very next decode step:
the ``steps`` count stays far below requests x max_new.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch mixtral-8x7b --reduced \
        --device cpu
    # on the GPU (the default device) at full width and depth
    PYTHONPATH=src python examples/serve_batched_torch.py --arch yi-6b

Random weights from seed 0; prompt lengths and ids from a generator seeded
100 (ids 1..vocab-1, off the EOS id 0).
"""
import argparse

import torch

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.device import resolve_device
from repro_torch.serving import Engine, aggregate_metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true", help="the arch's CPU-sized variant")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--slo-ttft-ms", type=float, default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    engine = Engine(
        model, params,
        n_slots=args.slots,
        page_size=8,
        max_len=args.max_prompt + args.max_new,
        eos_id=0,
    )

    gen = torch.Generator().manual_seed(100)
    for _ in range(args.requests):
        plen = int(torch.randint(4, args.max_prompt + 1, (), generator=gen))
        prompt = torch.randint(1, cfg.vocab, (plen,), generator=gen).tolist()
        engine.submit(prompt, max_new=args.max_new, slo_ttft_ms=args.slo_ttft_ms)

    completions = engine.drain()
    for rid in sorted(completions):
        c = completions[rid]
        ttft = f"{c.ttft_s * 1e3:6.1f}ms" if c.ttft_s is not None else "   shed"
        print(f"request {rid}: prompt={c.prompt_len:3d} finish={c.finish:6s} "
              f"ttft={ttft} tokens={c.tokens}")

    m = aggregate_metrics(completions)
    print(f"\n{int(m['requests'])} served / {int(m['shed'])} shed in "
          f"{engine.steps} engine steps on {device}: {int(m['tokens'])} tokens, "
          f"{m['tok_per_s']:.1f} tok/s, "
          f"TTFT p95 {m['ttft_p95_ms']:.1f}ms, "
          f"per-token p95 {m['per_token_p95_ms']:.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
