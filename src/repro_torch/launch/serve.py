"""Serving entry point (port of ``launch/serve.py``).

    python -m repro_torch.launch.serve --arch yi-6b [--reduced] [--device cpu]
    python -m repro_torch.launch.serve --arch whisper-large-v3 --reduced --device cpu

Token-prompt decoder LMs go through the continuous-batching ``Engine``
(request queue, SLO-aware admission, paged KV pool, per-step slot
recycling) with per-request metrics.  The encoder-frontend families
(Whisper's audio frames, Phi-3-vision's patch prefix) decode as one fixed
wave (``_serve_wave``): ``--slots`` prompts prefilled together, then greedy
decode; a lane that has emitted EOS keeps stepping but emits -1, and
generation and the token count stop at EOS.  The routing is the JAX CLI's:
``cfg.family == "audio" or cfg.prefix_tokens``.

Random weights from seed 0, random prompts from a ``torch.Generator`` seeded
1 (ids 1..vocab-1, off the default EOS id 0), the wave's prefixes and frames
(standard normal, in ``cfg.dtype``) from generators seeded 2 and 3, as the
JAX CLI keys them.  It runs on the GPU unless ``--device cpu`` is given, and
raises without a GPU.  The JAX CLI's ``--obs-dir`` is not ported (obs is
not).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
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


def wave_batch(cfg, slots: int, prompt_len: int, device) -> dict:
    """The fixed wave's inputs: ``tokens`` (slots, prompt_len) in
    [1, vocab) from seed 1, and a VLM's ``prefix`` or the audio family's
    ``frames`` (standard normal, ``cfg.dtype``) from seeds 2 and 3."""
    dtype = torch_dtype(cfg.dtype)
    batch = {"tokens": torch.tensor(make_prompts(slots, prompt_len, cfg.vocab, 1, device),
                                    device=device)}
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(2)
        batch["prefix"] = torch.randn((slots, cfg.prefix_tokens, cfg.prefix_dim),
                                      generator=gen, device=device).to(dtype)
    if cfg.family == "audio":
        gen = torch.Generator(device=device).manual_seed(3)
        batch["frames"] = torch.randn((slots, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=device).to(dtype)
    return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _serve_wave(model, cfg, params, args, *, keep_logits: bool = False) -> dict:
    """One fixed wave of ``args.slots`` lanes: prefill, then up to
    ``args.max_new - 1`` greedy decode steps.  A lane stops counting at
    ``args.eos``: it keeps stepping (the wave is fixed) but emits -1, and
    the wave ends once every lane is done.

    Returns ``tokens`` (slots, n) with -1 past each lane's EOS, ``stepped``
    (slots, n) the tokens as decoded (what each step was fed next),
    ``n_tokens`` (those not -1), ``prefill_s``, ``decode_s`` and
    ``step_s`` (each decode step, host clock, synchronised) and, with
    ``keep_logits``, ``logits``: the prefill's last position and each
    decode step's, each (slots, 1, V)."""
    device = model.device
    batch = wave_batch(cfg, args.slots, args.prompt_len, device)
    state = model.init_state(args.slots, args.prompt_len + args.max_new + cfg.prefix_tokens)
    decode = make_decode_step(model)
    _sync(device)
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch, state)
    tok = logits[:, -1:].argmax(dim=-1)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    kept = [logits[:, -1:]] if keep_logits else []
    done = tok[:, 0] == args.eos
    outputs, stepped, step_s = [tok], [tok], []
    for _ in range(args.max_new - 1):
        if bool(done.all()):
            break
        t0 = time.perf_counter()
        tok, logits, state = decode(params, tok, state)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        if keep_logits:
            kept.append(logits)
        # finished lanes keep stepping (fixed wave) but emit nothing: -1
        # marks their rows so they never reach the output or the count
        outputs.append(torch.where(done[:, None], -1, tok))
        stepped.append(tok)
        done = done | (tok[:, 0] == args.eos)
    gen = torch.cat(outputs, dim=1)
    out = {"tokens": gen, "stepped": torch.cat(stepped, dim=1),
           "n_tokens": int((gen != -1).sum()), "prefill_s": prefill_s,
           "decode_s": sum(step_s), "step_s": step_s}
    if keep_logits:
        out["logits"] = kept
    return out


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
    if cfg.family == "audio" or cfg.prefix_tokens:
        wave = _serve_wave(model, cfg, params, args)
        n, t = wave["n_tokens"], wave["decode_s"]
        print(f"prefill {wave['prefill_s']:.3f}s; decode {n} tokens in {t:.3f}s "
              f"({n / max(t, 1e-9):.1f} tok/s)")
        for i in range(min(args.slots, 2)):
            print(f"request {i}: {[x for x in wave['tokens'][i].tolist() if x != -1]}")
        return 0
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
