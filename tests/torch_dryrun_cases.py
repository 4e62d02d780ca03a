"""One sharded train step as the dry run evaluates it (``launch.dryrun
.evaluate_train``), run for real as one rank of a gloo fleet
(``tests/torch_dist.py``), for ``tests/test_torch_dryrun.py``.

``CASES`` names each model (reduced Mixtral and Yi-6B, the narrow VGG-11 of
``torch_model_axis_conv_cases``), its global batch and its optimizer;
``live_step`` builds the state from seed 0 (``make_train_state``), shards
it by ``state_shardings`` on ``launch.mesh.make_mesh(shape)`` and runs
``make_train_step`` inside ``use_reshard_rules`` under the dry run's
tracker and collective record, as the dry run does over fake tensors.  It
returns the record ``(op, bytes, group size)``, the tracked peak and the
launches by kernel.  No JAX here: the ranks are spawned processes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import build_model, get_arch
from repro_torch.data.synthetic import synthetic_arch_batch, synthetic_vision_batch
from repro_torch.optim import adam, constant, sgd
from repro_torch.policies.fixed import FixedPolicy


def case(name: str) -> dict:
    """(build, cfg, batch, optimizer) of a named case, each model on the CPU."""
    if name == "vgg11":
        from torch_model_axis_conv_cases import port_model

        return {"build": lambda: port_model("vgg11")[0], "cfg": None, "optimizer": sgd(0.9),
                "batch": lambda: synthetic_vision_batch(batch=4, image=32, channels=3,
                                                        n_classes=10, step=0, device="cpu")}
    cfg = get_arch(name).reduced()
    if name == "yi-6b":
        assert cfg.parallelism == "dp_only"
    return {"build": lambda: build_model(cfg, device="cpu"), "cfg": cfg, "optimizer": adam(),
            "batch": lambda: synthetic_arch_batch(cfg, batch=4, seq=8, step=3, device="cpu")}


@dataclasses.dataclass(frozen=True)
class Step:
    model: str
    shape: tuple
    mode: str

    @property
    def key(self) -> str:
        return f"{self.model}/{self.shape[0]}x{self.shape[1]}/{self.mode}"


def policy():
    return FixedPolicy(clip_norm=1.0)


def schedule():
    return constant(1e-3)


def live_step(rank: int, n: int, step: Step) -> dict:
    """``step`` on this rank of a live gloo fleet (module docstring)."""
    from repro_torch.kernels import launches
    from repro_torch.launch.analysis import MemoryTracker
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import DPTrainConfig, make_train_state, make_train_step
    from repro_torch.parallel import collectives
    from repro_torch.parallel.fsdp import ShardLayout
    from repro_torch.parallel.reshard import use_reshard_rules
    from repro_torch.parallel.sharding import state_shardings

    del n
    c, pol = case(step.model), policy()
    model = c["build"]()
    mesh = make_mesh(step.shape, "cpu")
    state = make_train_state(model, 0, c["optimizer"], pol)
    shardings = state_shardings(model, mesh, c["cfg"], state)
    state = ShardLayout(mesh, shardings["params"]).shard_state(state)
    batch = c["batch"]()
    dp = DPTrainConfig(clipping_mode=step.mode, clip_norm=1.0, noise_multiplier=1.0,
                       logical_batch=int(batch["mask"].shape[0]), policy=pol)
    tracker = MemoryTracker()
    tracker.add((state, batch))
    launches.reset()
    with use_reshard_rules(mesh, c["cfg"]):
        train_step = make_train_step(model, c["optimizer"], schedule(), dp, device="cpu",
                                     shardings=shardings)
        with collectives.recording() as record, tracker:
            train_step(state, batch)
    return {"rank": rank, "records": collectives.records(record), "peak": tracker.peak,
            "launches": {k: v["torch"] for k, v in launches.snapshot().items()}}
