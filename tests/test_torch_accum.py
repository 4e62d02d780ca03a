"""Gradient accumulation, the data pipeline and the CNN example of the port.

- k accumulated microsteps against one step on the whole logical batch:
  the accumulator's gradient sum, norms and mask before noise (5e-5
  absolute, scaled by max(1, the largest entry), as the oracle), and with
  ``noise_multiplier=0`` the parameters after ``make_accum_finalize``
  against ``make_train_step`` on the same samples and against the JAX
  package's ``make_accum_*`` (rtol 1e-5, atol 1e-6, as
  ``test_torch_cnn_step.py`` holds one train step);
- the quantile policy updates once per logical batch, on the whole
  batch's norms and mask, as the JAX package's finalize does (rtol 1e-6);
- ``DataPipeline.seek`` replays the same batches;
- ``examples/dp_finetune_cnn_torch.py --device cpu --steps 1`` runs, and
  with ``--tune`` measures and writes a plan that ``--plan`` adopts.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import policies as jpol
from repro.launch import steps as jsteps
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch import policies as tpol
from repro_torch.core import clipping as tclip
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.models import cnn as tcnn
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils.tree import flatten_dict
from test_torch_oracle import CPU, TINY_PLAN, pair
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
K, PHYSICAL = 3, 2  # microsteps of 2 samples: a logical batch of 6
MASK = (1.0, 0.0, 1.0, 1.0, 1.0, 0.0)
LR = 0.1


@pytest.fixture(autouse=True)
def _tiny_vgg(monkeypatch):
    monkeypatch.setitem(jcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    monkeypatch.setitem(tcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)


def _setup():
    """The narrow VGG with a logical batch of K * PHYSICAL samples, and its
    microbatches (numpy, the JAX package's layout)."""
    jm, tm, jparams, tparams, _ = pair("vgg")
    rng = np.random.default_rng(11)
    n = K * PHYSICAL
    batch = {"image": rng.standard_normal((n, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, size=(n,)).astype(np.int32),
             "mask": np.asarray(MASK, np.float32)}
    micro = [{k: v[i * PHYSICAL:(i + 1) * PHYSICAL] for k, v in batch.items()}
             for i in range(K)]
    return jm, tm, jparams, tparams, batch, micro


def _dp(mode, policy=None, noise=0.0):
    return dict(clipping_mode=mode, clip_norm=0.3, noise_multiplier=noise,
                logical_batch=K * PHYSICAL, accumulation_steps=K, policy=policy)


def _port_accum(tm, tparams, micro, dp, policy=None):
    opt = topt.sgd()
    state = {"params": tparams, "opt": opt.init(tparams), "step": 0,
             "rng": torch.Generator().manual_seed(0),
             "policy": (policy or tpol.FixedPolicy(0.3)).init_state(device=CPU)}
    cfg = tsteps.DPTrainConfig(**dp)
    acc = tsteps.make_accum_init(tparams, cfg.logical_batch)()
    step = tsteps.make_accum_microstep(tm, cfg)
    for i, mb in enumerate(micro):
        acc = step(state["params"], state["policy"], acc, interop.batch_from_numpy(mb, CPU), i)
    pre_noise = {k: (dict(flatten_dict(v)) if k == "grads" else v.clone())
                 for k, v in acc.items()}
    new, metrics = tsteps.make_accum_finalize(opt, tsched.constant(LR), cfg)(state, acc)
    return pre_noise, new, metrics


def _close_trees(got, want, tol=5e-5):
    scale = max([1.0] + [float(np.abs(np.asarray(v)).max()) for v in want.values()])
    for path, w in want.items():
        err = float(np.abs(np.asarray(got[path]) - np.asarray(w)).max())
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "mixed_ghost_taps", "vmap"])
def test_microsteps_sum_to_one_clipped_step(mode):
    """Before noise: the accumulator holds the whole batch's clipped
    gradient sum, norms, mask, loss sum and clip hits."""
    _, tm, _, tparams, batch, micro = _setup()
    pre, _, metrics = _port_accum(tm, tparams, micro, _dp(mode))
    fn = tclip.dp_value_and_clipped_grad(tm.loss_with_ctx,
                                         tclip.ClipConfig(mode=mode, clip_norm=0.3))
    loss, g, aux = fn(tparams, interop.batch_from_numpy(batch, CPU))
    _close_trees({k: v.numpy() for k, v in pre["grads"].items()},
                 {k: v.numpy() for k, v in flatten_dict(g).items()})
    torch.testing.assert_close(pre["norms"], aux["per_sample_norms"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pre["mask"], torch.tensor(MASK))
    # the loss of a microstep is the mean over its samples
    np.testing.assert_allclose(float(pre["loss"]) / K, float(loss), rtol=1e-5)
    assert float(pre["clip_hits"]) == float((aux["clip_factors"] < 1.0).sum())
    np.testing.assert_allclose(float(metrics["norm_max"]), float(aux["per_sample_norms"].max()),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed"])
def test_accumulated_update_matches_train_step_and_jax(mode):
    """noise_multiplier=0: K microsteps + finalize land on the parameters of
    one make_train_step on the whole logical batch, and on the JAX
    package's make_accum_* parameters."""
    jm, tm, jparams, tparams, batch, micro = _setup()
    _, new, _ = _port_accum(tm, tparams, micro, _dp(mode))
    assert new["step"] == 1
    cfg = tsteps.DPTrainConfig(**_dp(mode))
    opt = topt.sgd()
    direct, _ = tsteps.make_train_step(tm, opt, tsched.constant(LR), cfg, device=CPU)(
        {"params": tparams, "opt": opt.init(tparams), "step": 0,
         "rng": torch.Generator().manual_seed(0)},
        interop.batch_from_numpy(batch, CPU))
    got = flatten_dict(interop.grads_to_jax_layout(new["params"], tm.conv_weights))
    want_direct = flatten_dict(interop.grads_to_jax_layout(direct["params"], tm.conv_weights))
    for path, want in want_direct.items():
        np.testing.assert_allclose(got[path], want, rtol=1e-5, atol=1e-6, err_msg=path)

    jcfg = jsteps.DPTrainConfig(**{k: v for k, v in _dp(mode).items() if k != "policy"})
    jo = jopt.sgd()
    spec = jax.eval_shape(lambda p: p, jparams)
    acc = jsteps.make_accum_init(spec, jcfg.logical_batch)()
    jmicro = jax.jit(jsteps.make_accum_microstep(jm, jcfg))
    for i, mb in enumerate(micro):
        acc = jmicro(jparams, {"step": jnp.zeros((), jnp.int32)}, acc, mb, jnp.asarray(i))
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.PRNGKey(0)}
    jnew, _ = jsteps.make_accum_finalize(jo, lambda s: LR, jcfg)(jstate, acc)
    for path, want in flatten_dict(jax.tree_util.tree_map(np.asarray, jnew["params"])).items():
        np.testing.assert_allclose(got[path], want, rtol=1e-5, atol=1e-6, err_msg=path)


def test_quantile_updates_once_per_logical_batch():
    """The microsteps share one policy state; the finalize updates it once,
    on the whole logical batch's norms and mask, as JAX's finalize does."""
    jm, tm, jparams, tparams, batch, micro = _setup()
    kw = dict(target_quantile=0.5, lr=0.2, release_sigma=0.0, init_clip_norm=0.3)
    policy = tpol.QuantilePolicy(**kw)
    pre, new, _ = _port_accum(tm, tparams, micro, _dp("mixed_ghost", policy), policy)
    assert int(new["policy"]["step"]) == 1
    direct, _ = policy.update(policy.init_state(), pre["norms"], mask=pre["mask"])
    torch.testing.assert_close(new["policy"]["clip_norm"], direct["clip_norm"])

    jpolicy = jpol.QuantilePolicy(**kw)
    dp = {k: v for k, v in _dp("mixed_ghost").items() if k != "policy"}
    jcfg = jsteps.DPTrainConfig(**dp, policy=jpolicy)
    acc = jsteps.make_accum_init(jax.eval_shape(lambda p: p, jparams), jcfg.logical_batch)()
    jmicro = jax.jit(jsteps.make_accum_microstep(jm, jcfg))
    for i, mb in enumerate(micro):
        acc = jmicro(jparams, jpolicy.init_state(), acc, mb, jnp.asarray(i))
    jo = jopt.sgd()
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.PRNGKey(0), "policy": jpolicy.init_state()}
    jnew, _ = jsteps.make_accum_finalize(jo, lambda s: LR, jcfg)(jstate, acc)
    assert int(jnew["policy"]["step"]) == 1
    np.testing.assert_allclose(float(new["policy"]["clip_norm"]),
                               float(jnew["policy"]["clip_norm"]), rtol=1e-6)


def test_data_pipeline_seek_replays_the_stream():
    """Batches are a pure function of (step, shard): a seek replays them,
    and a fresh pipeline started at the same step gives the same ones."""
    def batch_fn(step, shard):
        g = torch.Generator().manual_seed(1000 * shard + step)
        return {"x": torch.randn(3, generator=g), "step": step}

    pipe = DataPipeline(batch_fn, prefetch=2, shard=1).start()
    try:
        first = [pipe.next() for _ in range(5)]
        assert [s for s, _ in first] == list(range(5))
        pipe.seek(2)
        again = [pipe.next() for _ in range(3)]
    finally:
        pipe.stop()
    assert [s for s, _ in again] == [2, 3, 4]
    for (s0, b0), (s1, b1) in zip(first[2:], again):
        assert s0 == s1 and torch.equal(b0["x"], b1["x"])
    other = DataPipeline(batch_fn, start_step=3, shard=1)
    try:
        step, b = other.next()
    finally:
        other.stop()
    assert step == 3 and torch.equal(b["x"], first[3][1]["x"])
    assert DataPipeline(batch_fn).shard == 0  # no process group: shard 0


def test_cnn_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "dp_finetune_cnn_torch.py"),
         "--device", "cpu", "--steps", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "layerwise decision" in out.stdout and "step 0: loss=" in out.stdout
    assert "privacy spent: eps=" in out.stdout


def test_cnn_example_tunes_on_the_cpu(tmp_path):
    """``--tune`` measures a plan on the CPU, prints the measured map against
    Eq. 4.1, the recommended mode and the certified batch, writes the plan
    where ``--plan`` says, and ``--plan`` alone adopts it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TUNER_CACHE=str(tmp_path))
    plan = tmp_path / "vgg11.json"
    cmd = [sys.executable, str(ROOT / "examples" / "dp_finetune_cnn_torch.py"),
           "--device", "cpu", "--steps", "1"]
    out = subprocess.run(cmd + ["--tune", "--plan", str(plan)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tuned on cpu:cpu: max physical batch = 16" in out.stdout
    assert "recommended mode:" in out.stdout and "kernel impls: ['torch']" in out.stdout
    assert "layerwise decision (Eq 4.1 vs measured)" in out.stdout
    assert "(measured: " in out.stdout and "step 0: loss=" in out.stdout
    assert plan.exists()
    again = subprocess.run(cmd + ["--plan", str(plan)], capture_output=True, text=True,
                           timeout=300, env=env, cwd=ROOT)
    assert again.returncode == 0, again.stderr[-2000:]
    assert f"adopted the plan in {plan}" in again.stdout and "(measured: " in again.stdout
