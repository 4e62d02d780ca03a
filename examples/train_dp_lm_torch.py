"""DP training of a registry LM in the PyTorch port: a few DP-SGD steps of
a dense or MoE decoder through ``launch.steps.make_train_step`` with
``adamw``, on the synthetic Markov token stream, under any clipping mode.

    PYTHONPATH=src python examples/train_dp_lm_torch.py --arch yi-6b --reduced --device cpu
    PYTHONPATH=src python examples/train_dp_lm_torch.py --arch mixtral-8x7b --reduced \\
        --device cpu --mode bk_mixed
    # full width on the GPU, depth cut to fit one card (bf16 compute, fp32 parameters)
    PYTHONPATH=src python examples/train_dp_lm_torch.py --arch yi-6b --layers 8 \\
        --batch 4 --seq 4096

Random weights from ``--seed``.  Each step prints the loss, the per-sample
norms' mean, the share of samples clipped and its wall time.
"""
import argparse
import dataclasses
import time

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.launch.steps import DPTrainConfig, make_train_state, make_train_step
from repro_torch.optim import adamw, constant
from repro_torch.utils.tree import flatten_dict

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="yi-6b")
ap.add_argument("--reduced", action="store_true", help="the arch's CPU-sized variant")
ap.add_argument("--layers", type=int, default=None, help="cut the depth (full width)")
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--mode", default="mixed_ghost", help="clipping mode")
ap.add_argument("--steps", type=int, default=3)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--lr", type=float, default=1e-3)
ap.add_argument("--seed", type=int, default=0)
args = ap.parse_args()

cfg = get_arch(args.arch)
if args.reduced:
    cfg = cfg.reduced()
if args.layers:
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
model = build_model(cfg, device=args.device)
optimizer = adamw()
state = make_train_state(model, args.seed, optimizer)
dp = DPTrainConfig(clipping_mode=args.mode, clip_norm=1.0, noise_multiplier=1.0,
                   logical_batch=args.batch)
step = make_train_step(model, optimizer, constant(args.lr), dp, device=model.device)
n_params = sum(x.numel() for x in flatten_dict(state["params"]).values())
print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} parameters, "
      f"{cfg.dtype} compute, {args.mode} on {model.device}")
for i in range(args.steps):
    batch = synthetic_arch_batch(cfg, batch=args.batch, seq=args.seq, step=i,
                                 device=model.device)
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])  # waits for the step
    print(f"step {i}: loss {loss:.4f}, norm mean {float(metrics['norm_mean']):.3f}, "
          f"clipped {float(metrics['clip_frac']):.2f}, {time.perf_counter() - t0:.2f} s")
