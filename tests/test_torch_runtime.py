"""The port's single-process runtime against the JAX package's:
checkpointing (``repro_torch.checkpoint``), the elastic replan, fault
injection and the watchdog / preemption / retry helpers
(``repro_torch.runtime``), and the FLOPs models (``launch/flops.py``,
``launch/analytic.py``).

Counterparts of ``tests/test_substrate.py``'s checkpoint and runtime cases
and ``tests/test_fleet_runtime.py``'s unit cases.  Where a module is pure
(the elastic plan, the injection spec, the FLOPs models), the same inputs go
through both packages and must give equal results.  Checkpoints cross both
ways: one written by ``repro.checkpoint.save_checkpoint`` restores in the
port (a bf16 leaf bit for bit), and the port's reads back with ``np.load``
and the JAX package's ``restore_checkpoint`` in the JAX layout.  The FLOPs
models run on every registry arch at full width from abstract shapes only
(JAX's ``eval_shape``, torch's ``meta`` device).  Exact equality throughout.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import build_model as jbuild
from repro.configs.registry import get_arch as jget
from repro.core import clipping as jclip
from repro.launch import analytic as janalytic
from repro.launch import flops as jflops
from repro.runtime import elastic as jelastic
from repro.runtime.inject import InjectionPlan as JInjectionPlan
from repro_torch import interop
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    snapshot_state,
)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, build_model
from repro_torch.core.clipping import discover_meta
from repro_torch.launch import analytic, flops
from repro_torch.launch.steps import make_train_state
from repro_torch.optim import adam
from repro_torch.policies import make_policy
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime.elastic import ElasticPlan, current_data_shards, elastic_plan
from repro_torch.runtime.fault import PreemptionHandler, StepWatchdog, retry
from repro_torch.runtime.inject import InjectedCrash, InjectionPlan
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401


# -- checkpoints -----------------------------------------------------------
def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    state = {"params": {"a": torch.arange(6.0).reshape(2, 3)}, "step": 7}
    save_checkpoint(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    step, restored = restore_checkpoint(tmp_path)
    assert step == 7
    assert np.array_equal(restored["params"]["a"], np.arange(6.0).reshape(2, 3))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_checkpoint_manager_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2, async_save=False)
    for step in range(1, 5):
        mgr.save(step, {"x": torch.tensor(step)})
    steps = sorted(int(p.stem.split("_")[1]) for p in tmp_path.iterdir()
                   if p.suffix == ".npz")
    assert steps == [3, 4] and mgr.latest() == 4


def _port_state(seed: int = 0, policy: str = "quantile") -> dict:
    model = build_model(ARCHS["yi-6b"].reduced(), device="cpu")
    pol = make_policy(policy, clip_norm=1.0, init_clip_norm=1.0)
    return make_train_state(model, seed, adam(), pol)


def test_train_state_roundtrip_with_generator_and_cast(tmp_path):
    """The port's state (Python-int step, a torch.Generator, policy state)
    restores through ``cast_to`` bit for bit, and the generator continues
    the saved stream: the noise after a resume is the noise without one."""
    state = _port_state()
    torch.randn(5, generator=state["rng"])  # advance past the seed
    mgr = CheckpointManager(tmp_path, save_every=1, async_save=True)
    mgr.save(3, state)
    mgr.wait()
    want = torch.randn(7, generator=state["rng"])
    fresh = _port_state(seed=5)
    step, got = mgr.restore(cast_to=fresh)
    assert step == 3 and got["step"] == state["step"] and isinstance(got["step"], int)
    for path, x in flatten_dict(got).items():
        if isinstance(x, torch.Tensor):
            ref = flatten_dict(state)[path]
            assert x.dtype == ref.dtype and torch.equal(x, ref), path
    assert torch.equal(torch.randn(7, generator=got["rng"]), want)
    # a checkpoint without the policy subtree keeps the fresh policy state
    flat = {k: v for k, v in flatten_dict(snapshot_state(state)).items()
            if not k.startswith("policy/")}
    save_checkpoint(tmp_path / "old", 1, unflatten_dict(flat))
    _, old = restore_checkpoint(tmp_path / "old", cast_to=fresh, fill=("policy",))
    assert torch.equal(old["policy"]["clip_norm"], fresh["policy"]["clip_norm"])
    with pytest.raises(KeyError, match="policy"):
        restore_checkpoint(tmp_path / "old", cast_to=fresh)


def test_async_snapshot_is_a_real_copy(tmp_path):
    """The writer thread owns a copy: a tensor written in place right after
    ``save`` returns does not reach the checkpoint."""
    x = torch.zeros(1000)
    mgr = CheckpointManager(tmp_path, save_every=1, async_save=True)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    _, got = restore_checkpoint(tmp_path, 1)
    assert float(got["x"].max()) == 0.0


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the JAX package writes (its params tree, a bf16 leaf,
    an int32 step) restores in the port: ``interop.params_from_jax`` of the
    numpy leaves equals the JAX params, and ``cast_to`` reads the bf16 leaf
    bit for bit."""
    jcfg = jget("yi-6b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    bf = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    jsave(tmp_path, 4, {"params": jparams, "step": jnp.asarray(4), "extra": {"bf": bf}})
    step, raw = restore_checkpoint(tmp_path)
    assert step == 4
    tparams = interop.params_from_jax(raw["params"], (), device="cpu")
    for path, x in flatten_dict(jax.device_get(jparams)).items():
        assert np.array_equal(flatten_dict(tparams)[path].numpy(), np.asarray(x)), path
    like = {"params": tparams, "step": 0, "extra": {"bf": torch.zeros(7, dtype=torch.bfloat16)}}
    _, cast = restore_checkpoint(tmp_path, cast_to=like)
    assert cast["step"] == 4
    assert cast["extra"]["bf"].dtype == torch.bfloat16
    assert np.array_equal(cast["extra"]["bf"].view(torch.int16).numpy(),
                          np.asarray(bf).view(np.int16))


def test_port_checkpoint_reads_back_in_the_jax_layout(tmp_path):
    """The port's checkpoint is the JAX package's format: ``np.load`` gives
    the parameters under the JAX paths and layout, the sidecar names bf16 as
    the JAX package does, and ``repro.checkpoint.restore_checkpoint`` reads
    it."""
    jcfg = jget("yi-6b").reduced()
    jparams = jax.device_get(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tparams = interop.params_from_jax(jparams, (), device="cpu")
    bf = torch.linspace(-3, 3, 7).to(torch.bfloat16)
    save_checkpoint(tmp_path, 2, {"params": tparams, "step": 2, "bf": bf})
    with np.load(tmp_path / "step_2.npz") as z:
        got = {k: z[k] for k in z.files}
    want = flatten_dict({"params": jparams})
    assert set(got) == set(want) | {"step", "bf"}
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert got["bf"].dtype == np.dtype("V2")
    meta = json.loads((tmp_path / "step_2.json").read_text())
    assert meta["format"] == 1 and meta["leaves"]["bf"]["dtype"] == "bfloat16"
    step, jstate = jrestore(tmp_path)
    assert step == 2 and int(jstate["step"]) == 2
    assert np.array_equal(jstate["params"]["embed"]["e"], jparams["embed"]["e"])


def test_manager_skips_stray_files_and_rotates(tmp_path):
    mgr = CheckpointManager(tmp_path, save_every=1, keep=2, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    (tmp_path / ".tmp_step_9.npz").write_bytes(b"partial")
    (tmp_path / "step_3.npz.bak").write_bytes(b"junk")
    (tmp_path / "notes.txt").write_text("hi")
    (tmp_path / "subdir").mkdir()
    assert mgr.latest() == 3 and latest_step(tmp_path) == 3
    assert mgr.available_steps() == [2, 3]
    mgr.save(4, {"x": torch.full((4,), 4.0)})
    assert mgr.available_steps() == [3, 4]
    step, state = mgr.restore()
    assert step == 4 and float(state["x"][0]) == 4.0


def test_restore_falls_back_past_torn_newest_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, save_every=1, keep=3, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((8,), float(s))})
    p3 = tmp_path / "step_3.npz"
    p3.write_bytes(p3.read_bytes()[:40])
    (tmp_path / "step_2.npz").write_bytes(b"\x00garbage\x00" * 8)
    step, state = mgr.restore(cast_to={"x": torch.zeros(8)})
    assert step == 1 and float(state["x"][0]) == 1.0
    with pytest.raises(Exception):
        mgr.restore(step=3)


def test_restore_raises_when_nothing_readable(tmp_path):
    mgr = CheckpointManager(tmp_path, save_every=1, async_save=False)
    mgr.save(1, {"x": torch.zeros(2)})
    (tmp_path / "step_1.npz").write_bytes(b"nope")
    with pytest.raises(FileNotFoundError, match="no readable"):
        mgr.restore()


def test_manager_on_saved_fires_on_async_writer_thread(tmp_path):
    seen = []
    mgr = CheckpointManager(
        tmp_path, save_every=1, async_save=True,
        on_saved=lambda step, path: seen.append(
            (step, path.name, threading.current_thread().name)),
    )
    mgr.save(1, {"x": torch.zeros(3)})
    mgr.wait()
    assert seen and seen[0][:2] == (1, "step_1.npz")
    assert seen[0][2] != threading.main_thread().name


# -- elastic plan: the same fields and the same refusals as the JAX package --
_LAYOUTS = list(itertools.product((4, 6, 9, 10, 64, 256), (0, 1, 2, 3, 8, 16), (1, 2, 4, 8)))


def _plan_or_error(mod, **kw):
    try:
        return dataclasses.astuple(mod.elastic_plan(**kw))
    except ValueError as e:
        return ("ValueError", str(e))


def test_elastic_plan_matches_jax_over_a_grid():
    for logical, shards, cap in _LAYOUTS:
        kw = dict(logical_batch=logical, data_shards=shards, max_per_shard=cap)
        assert _plan_or_error(telastic, **kw) == _plan_or_error(jelastic, **kw), kw
    plan = ElasticPlan(data_shards=4, per_shard_batch=2, accumulation_steps=3, note="")
    jplan = jelastic.ElasticPlan(data_shards=4, per_shard_batch=2, accumulation_steps=3,
                                 note="")
    for n in (1, 2, 4):
        assert plan.execution(n) == jplan.execution(n)
    for bad in (3, 0):
        with pytest.raises(ValueError):
            plan.execution(bad)
        with pytest.raises(ValueError):
            jplan.execution(bad)


def test_elastic_plan_preserves_logical_batch_across_shrink():
    before = elastic_plan(logical_batch=64, data_shards=8, max_per_shard=8)
    after = elastic_plan(logical_batch=64, data_shards=2, max_per_shard=8)
    assert after.accumulation_steps == 4 * before.accumulation_steps
    assert after.per_shard_batch == before.per_shard_batch


def test_current_data_shards_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_ELASTIC_SHARDS", raising=False)
    assert current_data_shards(None) == 1 and current_data_shards(4) == 4
    monkeypatch.setenv("REPRO_ELASTIC_SHARDS", "2")
    assert current_data_shards(None) == 2 and current_data_shards(8) == 8


# -- fault injection: the same injectors and refusals as the JAX package ---
@pytest.mark.parametrize("spec", ["crash@3,slow@1:0.01", "torn@4,corrupt@2",
                                  "shrink@5:1, sigterm@2", "crash@0"])
def test_injection_spec_matches_jax(spec):
    got = [(i.kind, i.step, i.value) for i in InjectionPlan.from_spec(spec, env="").injectors]
    want = [(i.kind, i.step, i.value)
            for i in JInjectionPlan.from_spec(spec, env="").injectors]
    assert got == want


@pytest.mark.parametrize("spec", ["crash5", "warp@3", "slow@3", "shrink@3", "shrink@3:0",
                                  "shrink@3:1.5", "crash@x"])
def test_injection_rejects_the_jax_bad_specs(spec):
    with pytest.raises(ValueError):
        JInjectionPlan.from_spec(spec, env="")
    with pytest.raises(ValueError):
        InjectionPlan.from_spec(spec, env="")


def test_injection_one_shot_and_env_merge(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_INJECT", raising=False)
    plan = InjectionPlan.from_spec("crash@3,slow@1:0.01")
    plan.on_step(0)
    plan.on_step(1)
    with pytest.raises(InjectedCrash):
        plan.on_step(3)
    plan.on_step(3)  # one-shot
    monkeypatch.setenv("REPRO_FAULT_INJECT", "torn@7")
    assert sorted(i.kind for i in InjectionPlan.from_spec("crash@2").injectors) == [
        "crash", "torn"]


def test_torn_injector_truncates_checkpoint(tmp_path):
    plan = InjectionPlan.from_spec("torn@2", env="")
    p = save_checkpoint(tmp_path, 2, {"a": torch.arange(100.0)})
    full = p.stat().st_size
    plan.on_checkpoint_saved(2, p)
    assert 0 < p.stat().st_size < full


# -- watchdog / preemption / retry -----------------------------------------
def test_watchdog_trip_accounting(monkeypatch):
    import repro_torch.runtime.fault as fault

    clock = {"t": 0.0}
    monkeypatch.setattr(fault.time, "monotonic", lambda: clock["t"])
    trips = []
    wd = StepWatchdog(trip_factor=3.0, on_trip=lambda s, dt, med: trips.append((s, dt, med)))

    def step(i, dt):
        wd.start_step()
        clock["t"] += dt
        return wd.end_step(i)

    for i in range(10):
        step(i, 1.0)
    assert wd.trips == 0
    step(10, 10.0)
    assert wd.trips == 1 and trips == [(10, 10.0, 1.0)]
    step(11, 1.0)
    step(12, 4.0)
    assert wd.trips == 2


def test_preemption_handler_flag_and_uninstall():
    prev = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler().install()
    try:
        assert not h.preempted()
        h.request_stop()
        assert h.preempted() and signal.getsignal(signal.SIGTERM) != prev
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev
    holder = {}
    t = threading.Thread(target=lambda: holder.setdefault("h", PreemptionHandler().install()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    holder["h"].request_stop()
    assert holder["h"].preempted()
    holder["h"].uninstall()


def test_launch_env_defaults_never_clobber(monkeypatch):
    """``apply_env`` sets the allocator and cuBLAS defaults only where the
    caller set nothing, and warns once torch is imported (it is, here)."""
    from repro_torch.launch import env

    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with pytest.warns(UserWarning, match="after torch was imported"):
        env.apply_env()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    machine, cores, device = env.host_fingerprint().split("-", 2)
    assert cores == str(os.cpu_count()) and device == "cpu"


def test_retry_eventually_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 42

    assert retry(flaky, attempts=4, backoff_s=0.001) == 42


# -- FLOPs models: every registry arch at full width, abstract shapes only --
def _meta_batch(cfg, b: int, s: int) -> dict:
    text = s - (cfg.prefix_tokens or 0)
    batch = {"tokens": torch.zeros((b, text), dtype=torch.long, device="meta"),
             "labels": torch.zeros((b, text), dtype=torch.long, device="meta"),
             "mask": torch.ones((b,), device="meta")}
    if cfg.family == "vlm":
        batch["prefix"] = torch.empty((b, cfg.prefix_tokens, cfg.prefix_dim), device="meta")
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model), device="meta")
    return batch


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_flops_models_match_jax_at_full_width(name):
    """count_params, model_flops, serve_matmul_flops and cell_flops (every
    mode) equal the JAX package's, the taps discovered at batch 1 x 16 text
    positions on the meta device and under eval_shape."""
    from repro.data.synthetic import synthetic_arch_batch as jbatch

    cfg, jcfg = ARCHS[name], jget(name)
    model, jmodel = build_model(cfg, device="meta"), jbuild(jcfg)
    s = 16 + (cfg.prefix_tokens or 0)
    assert flops.count_params(model, cfg) == jflops.count_params(jmodel, jcfg)
    train, jtrain = ShapeConfig("t", s, 2, "train"), JShape("t", s, 2, "train")
    decode, jdecode = ShapeConfig("d", s, 2, "decode"), JShape("d", s, 2, "decode")
    assert flops.model_flops(model, cfg, train) == jflops.model_flops(jmodel, jcfg, jtrain)
    assert analytic.serve_matmul_flops(model, cfg, decode) == \
        janalytic.serve_matmul_flops(jmodel, jcfg, jdecode)
    meta = discover_meta(model.loss_with_ctx, flops.abstract_params(model),
                         _meta_batch(cfg, 1, s))
    jmeta = jclip.discover_meta(
        jmodel.loss_with_ctx, jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0))),
        jax.eval_shape(lambda: jbatch(jcfg, batch=1, seq=s)))
    for kind in ("train", "prefill", "decode"):
        shape, jshape = ShapeConfig("t", s, 1, kind), JShape("t", s, 1, kind)
        for mode in ("non_private", "vmap", "mixed_ghost", "bk_mixed", "ghost",
                     "mixed_ghost_taps"):
            got = analytic.cell_flops(meta, cfg, shape, mode).to_dict()
            want = janalytic.cell_flops(jmeta, jcfg, jshape, mode).to_dict()
            assert got == want, (name, kind, mode)
