"""Quickstart: DP training with mixed ghost clipping in the PyTorch port.

The port's counterpart of ``examples/quickstart.py`` (the paper's
Appendix-E privacy engine demo): a reduced Yi-6B, ``PrivacyEngine`` in
``mixed_ghost``, its clipped gradients, the noise and the privacy spent.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py            # on the GPU
"""
import argparse

import torch

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.engine import PrivacyEngine
from repro_torch.data.synthetic import SyntheticLMConfig, synthetic_lm_batch
from repro_torch.optim import adam, apply_updates

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--steps", type=int, default=10)
args = ap.parse_args()

# 1. any model in the zoo, reduced for a small run
cfg = get_arch("yi-6b").reduced()
model = build_model(cfg, device=args.device)
params = model.init(torch.Generator(device=model.device).manual_seed(0))

# 2. attach the privacy engine (paper Appendix E, functional style)
engine = PrivacyEngine(
    loss_with_ctx=model.loss_with_ctx,
    batch_size=8,
    sample_size=50_000,
    epochs=3,
    max_grad_norm=0.1,
    target_epsilon=3.0,
    mode="mixed_ghost",  # the paper's 'ghost-mixed'
    device=model.device,
)
print(f"sigma={engine.noise_multiplier:.3f} for (eps=3, delta={engine.target_delta:.1e})")

data_cfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=64, batch=8)
engine.validate(params, synthetic_lm_batch(data_cfg, 0, device=model.device))  # no escapes

# 3. the usual train loop; gradients come pre-clipped, privatize() adds noise
grad_fn = engine.clipped_grad_fn()
opt = adam()
opt_state = opt.init(params)
noise = torch.Generator(device=model.device).manual_seed(1)
for step in range(args.steps):
    batch = synthetic_lm_batch(data_cfg, step, device=model.device)
    loss, grad_sum, aux = grad_fn(params, batch)
    grads = engine.privatize(grad_sum, noise)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params, step, 1e-3)
        params = apply_updates(params, updates)
    engine.record_step()
    print(f"step {step}: loss={float(loss):.4f} "
          f"median_grad_norm={float(aux['per_sample_norms'].median()):.2f}")

eps, delta = engine.privacy_spent()
print(f"privacy spent: eps={eps:.3f} delta={delta:.1e}")
