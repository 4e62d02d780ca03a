"""The paper's home ground in the PyTorch port: DP-train a VGG-11 (GroupNorm)
on image data with mixed ghost clipping, show the layerwise decision the
engine made, and take a few accumulated steps fed by a prefetching
``DataPipeline``.

    PYTHONPATH=src python examples/dp_finetune_cnn_torch.py              # on the GPU
    PYTHONPATH=src python examples/dp_finetune_cnn_torch.py --device cpu --steps 1
    PYTHONPATH=src python examples/dp_finetune_cnn_torch.py --tune       # measure a plan

Each logical batch is ``--accum`` microbatches of ``--physical`` samples:
the microsteps clip and fold into one accumulator on the device, and the
finalize adds the noise once, updates the clipping policy and the
parameters.  ``--tune`` times ghost against instantiate per tap on this
device, certifies the largest physical batch under the paper's 16 GB budget
by trial (on the CPU the trials cannot see a budget: the search stops at
the logical batch) and
writes the ClipPlan (``--plan`` names the file, else the tuner's cache);
``--plan`` alone adopts a plan written before.  The measured branches are
printed against Eq. 4.1's.
"""
import argparse

from repro_torch.core.clipping import discover_meta
from repro_torch.core.decision import decide
from repro_torch.core.engine import PrivacyEngine
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import synthetic_vision_batch
from repro_torch.launch.steps import (
    DPTrainConfig,
    make_accum_finalize,
    make_accum_init,
    make_accum_microstep,
    make_train_state,
)
from repro_torch.models.cnn import VGG
from repro_torch.optim import adam, constant
from repro_torch.tuner import ClipPlan, MeasureConfig
from repro_torch.utils.tree import flatten_dict

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--steps", type=int, default=4, help="logical batches")
ap.add_argument("--physical", type=int, default=8, help="samples per microbatch")
ap.add_argument("--accum", type=int, default=2, help="microbatches per logical batch")
ap.add_argument("--tune", action="store_true",
                help="profile ghost vs instantiate per tap on this device")
ap.add_argument("--plan", default=None, help="ClipPlan path (default with --tune: the cache)")
args = ap.parse_args()

model = VGG("vgg11", n_classes=10, device=args.device)
dev = model.device
logical = args.physical * args.accum
engine = PrivacyEngine(
    loss_with_ctx=model.loss_with_ctx,
    batch_size=logical,
    sample_size=50_000,
    epochs=1,
    max_grad_norm=0.1,
    target_epsilon=2.0,
    mode="mixed_ghost",
    device=dev,
)
opt = adam()
state = make_train_state(model, 0, opt, engine.clip_policy)
n = sum(x.numel() for x in flatten_dict(state["params"]).values())
print(f"VGG-11 (GroupNorm), {n / 1e6:.2f}M params on {dev}; "
      f"noise multiplier {engine.noise_multiplier:.3f}")


def batch_fn(step: int, shard: int) -> dict:
    return synthetic_vision_batch(batch=args.physical, image=32, channels=3, n_classes=10,
                                  step=step, shard=shard, device=dev)


first = batch_fn(0, 0)
engine.validate(state["params"], first)

measured = {}
if args.tune:
    # measured-cost autotuning: time the branches per tap on this device,
    # certify the max physical microbatch by trial, write the ClipPlan
    plan = engine.tune(
        state["params"], first, arch="vgg11-cifar",
        measure=MeasureConfig(repeats=3, warmup=1),
        hi_cap=logical if dev.type == "cpu" else 4096,
        plan_path=args.plan if args.plan else "auto",
    )
    measured = plan.branch_map()
    print(f"\ntuned on {plan.device}: max physical batch = {plan.physical_batch} "
          f"({plan.accumulation_steps} microstep(s) of {logical} samples)")
    print(f"three-way verdict: mixed_ghost={plan.mode_cost_us('mixed_ghost'):.0f}us "
          f"bk_mixed={plan.mode_cost_us('bk_mixed'):.0f}us per step "
          f"-> recommended mode: {plan.recommended_mode()}")
    print(f"kernel impls: {sorted({impl for _, _, impl in plan.kernels})}")
elif args.plan:
    engine.use_plan(ClipPlan.load(args.plan))
    measured = engine.plan.branch_map()
    print(f"\nadopted the plan in {args.plan} (measured on {engine.plan.device})")

# the paper's Table-3-style layerwise decision for this model and input
print("\nlayerwise decision (Eq 4.1%s):" % (" vs measured" if measured else ""))
for name, m in sorted(discover_meta(model.loss_with_ctx, state["params"], first).items()):
    if m.kind == "matmul":
        analytic = decide(m, mode=engine.mode)
        line = f"  {name:22s} T={m.T:5d} D={m.D:6d} p={m.p:5d} -> {analytic}"
        if name in measured:
            flip = "  <- flip" if measured[name] != analytic else ""
            line += f"  (measured: {measured[name]}){flip}"
        print(line)

dp = DPTrainConfig(clipping_mode=engine.mode, clip_norm=engine.max_grad_norm,
                   noise_multiplier=engine.noise_multiplier, logical_batch=logical,
                   accumulation_steps=args.accum, policy=engine.clip_policy,
                   plan=engine.plan)
init = make_accum_init(state["params"], logical)
micro = make_accum_microstep(model, dp)
finalize = make_accum_finalize(opt, constant(5e-3), dp)

pipe = DataPipeline(batch_fn, prefetch=2).start()
print()
try:
    for step in range(args.steps):
        acc = init()
        for i in range(args.accum):
            _, batch = pipe.next()
            acc = micro(state["params"], state["policy"], acc, batch, i)
        state, metrics = finalize(state, acc)
        engine.record_step()
        print(f"step {step}: loss={float(metrics['loss']):.4f} "
              f"clip_frac={float(metrics['clip_frac']):.2f} "
              f"norm_mean={float(metrics['norm_mean']):.3f}")
finally:
    pipe.stop()
eps, delta = engine.privacy_spent()
print(f"\nprivacy spent: eps={eps:.3f}, delta={delta:.1e}")
