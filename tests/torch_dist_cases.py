"""One DP step of a reduced registry arch, on one process or as one rank of
a gloo fleet (``tests/torch_dist.py``), for ``tests/test_torch_dist_step.py``.

``step_case`` builds the model, the train state (seed 0) and a global batch
from seeded generators, so every rank and the one-process reference start
from the same values; on a fleet it shards the state by
``state_shardings`` and runs inside ``use_reshard_rules`` on
``make_host_mesh``.  The clipped call is ``make_clipped_microstep``; the
update is ``make_train_step`` where the case says ``train_step``, else
the same tail alone (``make_noise_finalize``), or the accumulation trio.
It returns numpy arrays: the global loss, per-sample norms and clip
factors of the clipped call, its gradient sum and the parameters, Adam
moments and policy state after the step (gathered to full leaves), a
full-size noise draw through the sharded path, and each leaf's stored
fraction.  No JAX here: the ranks are spawned processes.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.clipping import VmapUnderShardingError
from repro_torch.core.noise import add_dp_noise
from repro_torch.data.poisson import poisson_sample_mask
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (
    DPTrainConfig,
    make_accum_finalize,
    make_accum_init,
    make_accum_microstep,
    make_clipped_microstep,
    make_noise_finalize,
    make_train_state,
    make_train_step,
)
from repro_torch.optim import adam, constant
from repro_torch.parallel.fsdp import ShardLayout, sharded_fraction
from repro_torch.parallel.reshard import use_reshard_rules
from repro_torch.parallel.sharding import state_shardings
from repro_torch.policies import make_policy
from repro_torch.utils.tree import flatten_dict

BATCH = 4
SEQ = 8
CLIP = 0.3


@dataclasses.dataclass(frozen=True)
class Case:
    mode: str
    policy: str = "fixed"
    accum: int = 1
    remat: bool = True
    poisson: bool = False
    batch: int = BATCH
    train_step: bool = False  # the update through make_train_step (a second clipped call)

    @property
    def key(self) -> str:
        return (f"{self.mode}/{self.policy}/accum{self.accum}/b{self.batch}"
                f"{'' if self.remat else '/noremat'}{'/poisson' if self.poisson else ''}"
                f"{'/step' if self.train_step else ''}")


def _policy(name: str):
    return make_policy(name, clip_norm=CLIP, init_clip_norm=CLIP, gamma=0.01,
                       target_quantile=0.5, lr=0.2, release_sigma=1.0,
                       groups=("lm_head", "embed"))


def _np(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in flatten_dict(tree).items()}


def _batches(cfg, case: Case) -> list:
    """The global batch of each microstep (every rank builds the same)."""
    micro = case.batch // case.accum
    out = []
    for i in range(case.accum):
        b = synthetic_arch_batch(cfg, batch=micro, seq=SEQ, step=3, shard=i, device="cpu")
        # labels ignored at some positions, as real data has them
        b["labels"][0, :3] = -100
        if case.poisson:
            b["mask"] = poisson_sample_mask(torch.Generator().manual_seed(11 + i), micro, 0.5)
        out.append(b)
    return out


def step_case(arch: str, case: Case, mesh=None) -> dict:
    cfg = dataclasses.replace(get_arch(arch).reduced(), remat=case.remat)
    model = build_model(cfg, device="cpu")
    policy = _policy(case.policy)
    opt = adam()
    dp = DPTrainConfig(clipping_mode=case.mode, clip_norm=CLIP, noise_multiplier=0.5,
                       logical_batch=case.batch, accumulation_steps=case.accum, policy=policy)
    state = make_train_state(model, 0, opt, policy)
    batches = _batches(cfg, case)
    shardings, layout = None, None
    ctx = contextlib.nullcontext()
    if mesh is not None:
        shardings = state_shardings(model, mesh, cfg, state)
        layout = ShardLayout(mesh, shardings["params"])
        full_bytes = layout.local_bytes(state["params"])
        state = layout.shard_state(state)
        ctx = use_reshard_rules(mesh, cfg)
    sched = constant(1e-3)
    with ctx:
        loss, g, aux = make_clipped_microstep(model, dp, shardings)(
            state["params"], batches[0], state["policy"])
        if case.train_step:
            new, metrics = make_train_step(model, opt, sched, dp, device="cpu",
                                           shardings=shardings)(state, batches[0])
        elif case.accum == 1:
            new = make_noise_finalize(opt, sched, dp, shardings=shardings)(
                state, g, aux["per_sample_norms"], batches[0].get("mask"))
            metrics = {"loss": loss}
        else:
            acc = make_accum_init(state["params"], case.batch)()
            micro = make_accum_microstep(model, dp, shardings=shardings)
            for i, b in enumerate(batches):
                acc = micro(state["params"], state["policy"], acc, b, i)
            new, metrics = make_accum_finalize(opt, sched, dp, shardings=shardings)(state, acc)
        noise = add_dp_noise({k: torch.zeros_like(v) for k, v in flatten_dict(g).items()},
                             torch.Generator().manual_seed(5), 1.0, layout=layout)
        out = {"loss": float(loss), "norms": aux["per_sample_norms"].numpy(),
               "factors": aux["clip_factors"].numpy(), "metric_loss": float(metrics["loss"]),
               "policy": _np(new["policy"]) if isinstance(new["policy"], dict) else {}}
        if layout is not None:
            out["fraction"] = sharded_fraction(layout, new["params"])
            out["moment_fraction"] = sharded_fraction(layout, new["opt"]["m"])
            out["stored_bytes"] = layout.local_bytes(new["params"]) / full_bytes
            g, noise = layout.gather(g), layout.gather(noise)
            new = layout.gather_state(new)
    out.update(grads=_np(g), noise=_np(noise), params=_np(new["params"]),
               m=_np(new["opt"]["m"]), v=_np(new["opt"]["v"]))
    return out


def fleet_cases(rank: int, n: int, arch: str, cases: list) -> dict:
    """Every case on this rank of the fleet; one result dict per case key
    (a ``vmap`` case gives the name of the error it must raise)."""
    del rank, n
    mesh = make_host_mesh("cpu")
    out = {}
    for c in cases:
        try:
            out[c.key] = step_case(arch, c, mesh)
        except VmapUnderShardingError as e:
            out[c.key] = type(e).__name__
    return out
