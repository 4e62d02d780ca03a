"""The port's train CLI (``python -m repro_torch.launch.train``) on the CPU.

- Parity with the JAX CLI: both run ``yi-6b --reduced --seq 16 --batch 2``
  for 3 steps with ``--noise-multiplier 0`` under the fixed policy, from the
  same initial parameters (the JAX package's, carried across by
  ``interop.params_from_jax``) on the same numpy-made batches (each CLI
  module's ``synthetic_arch_batch`` and state builder monkeypatched here).
  Tolerance: final parameters within 1e-5 of each leaf's largest entry, the
  per-step losses within 1e-5 relative (fp32 on both sides; the two
  packages' sums round differently).
- Epsilon: a run's summary equals the JAX package's ``RDPAccountant``
  composed step by step over the same steps (exactly).
- Bit-exact resume: a crash at step 4 with ``--auto-restart`` lands on the
  final state of the uninterrupted run, leaf for leaf (the generator's
  state and the policy state included), with equal epsilon, under the
  fixed, automatic and quantile policies and with ``--poisson``; across a
  2 -> 1 shard shrink (the elastic replan); past a torn checkpoint.
- SIGTERM preemption checkpoints and exits 0, the retry classification,
  a config error that burns no restart, ``--consensus``'s refusal,
  ``--tune --plan`` / ``--plan`` / ``--mode auto`` with accumulation, and
  the GPU default that raises without one.
"""
from __future__ import annotations

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.accountant import RDPAccountant as JRDPAccountant
from repro_torch import interop
from repro_torch.checkpoint import latest_step
from repro_torch.launch import train
from repro_torch.obs import read_jsonl
from repro_torch.runtime.inject import InjectedCrash
from repro_torch.tuner.consensus import PlanConsensusError
from torch_threads import torch_threads_per_worker  # noqa: F401

ARCH = ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--seq", "16", "--log-every", "4"]
RESUME = ["--steps", "6", "--batch", "2", "--ckpt-every", "2"]
PARAM_TOL = 1e-5  # of each leaf's largest entry
LOSS_RTOL = 1e-5


def _run(tmp_path, name, extra, **kw):
    d = tmp_path / name
    assert train.main(ARCH + ["--ckpt-dir", str(d)] + extra, **kw) == 0
    return d


def _final_state(d, step):
    with np.load(d / f"step_{step}.npz") as z:
        return {k: np.array(z[k]) for k in z.files}


def _summary(d):
    return json.loads((d / "summary.json").read_text())


def _assert_bit_identical(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), f"leaf {k} diverged"


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Uninterrupted runs, one per argument list, shared by the cases that
    compare against the same one."""
    cache = {}

    def get(extra):
        key = tuple(extra)
        if key not in cache:
            cache[key] = _run(tmp_path_factory.mktemp("straight"), "run", list(extra))
        return cache[key]

    return get


# -- parity with the JAX CLI -----------------------------------------------
def _numpy_batches(n: int, batch: int, seq: int, vocab: int) -> list[dict]:
    rng = np.random.default_rng(23)
    return [{"tokens": rng.integers(0, vocab, (batch, seq)),
             "labels": rng.integers(0, vocab, (batch, seq)),
             "mask": np.ones((batch,), np.float32)} for _ in range(n)]


def test_train_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    import repro.launch.train as jtrain
    from repro.launch.steps import make_train_state as jmake_state

    seq, batch, steps = 16, 2, 3
    batches = _numpy_batches(steps, batch, seq, 128)
    jparams = {}

    def jbatch(cfg, *, batch, seq, step=0, shard=0):
        return {k: jnp.asarray(v) for k, v in batches[step % steps].items()}

    def jstate(model, key, optimizer, policy=None):
        state = jmake_state(model, key, optimizer, policy)
        jparams["tree"] = jax.device_get(state["params"])
        return state

    def tbatch(cfg, *, batch, seq, step=0, shard=0, device=None):
        return interop.batch_from_numpy(batches[step % steps], device=device)

    real_tstate = train.make_train_state

    def tstate(model, seed, optimizer, policy=None):
        state = real_tstate(model, seed, optimizer, policy)
        state["params"] = interop.params_from_jax(jparams["tree"], (), device=model.device)
        state["opt"] = optimizer.init(state["params"])
        return state

    monkeypatch.setattr(jtrain, "synthetic_arch_batch", jbatch)
    monkeypatch.setattr(jtrain, "make_train_state", jstate)
    monkeypatch.setattr(train, "synthetic_arch_batch", tbatch)
    monkeypatch.setattr(train, "make_train_state", tstate)
    argv = ["--arch", "yi-6b", "--reduced", "--seq", str(seq), "--batch", str(batch),
            "--steps", str(steps), "--noise-multiplier", "0", "--log-every", "1"]
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert jtrain.main(argv + ["--ckpt-dir", str(jd)]) == 0
    assert train.main(argv + ["--device", "cpu", "--ckpt-dir", str(td)]) == 0
    jlosses = [m["loss"] for m in read_jsonl(jd / "metrics.jsonl") if m["kind"] == "train_step"]
    tlosses = [m["loss"] for m in read_jsonl(td / "metrics.jsonl") if m["kind"] == "train_step"]
    assert len(jlosses) == len(tlosses) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL, atol=0)
    jfinal, tfinal = _final_state(jd, steps), _final_state(td, steps)
    for k, want in jfinal.items():
        if not k.startswith("params/"):
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(tfinal[k].astype(np.float64) - want).max())
        assert err <= PARAM_TOL * scale, (k, err, scale)
    assert _summary(td)["logical_batch"] == _summary(jd)["logical_batch"] == batch


def test_epsilon_equals_the_jax_accountant(straight):
    """The summary's epsilon is the JAX package's RDP accountant composed one
    step at a time over the run's q and sigma (gradient, then the quantile
    release), exactly."""
    s = _summary(straight(RESUME + ["--clip-policy", "quantile"]))
    acct = JRDPAccountant()
    q = 2 / 50000
    for _ in range(6):
        acct.step(q=q, sigma=1.0, steps=1)
        acct.step(q=q, sigma=1.0, steps=1)  # the quantile release, sigma 1
    assert s["epsilon"] == acct.get_epsilon(1 / (2 * 50000))
    assert s["delta"] == 1 / (2 * 50000) and s["step"] == 6


# -- bit-exact resume ------------------------------------------------------
@pytest.mark.parametrize("extra", [["--clip-policy", "fixed"],
                                   ["--clip-policy", "automatic"],
                                   ["--clip-policy", "quantile"],
                                   ["--clip-policy", "fixed", "--poisson"]],
                         ids=["fixed", "automatic", "quantile", "poisson"])
def test_bitexact_resume_after_crash(tmp_path, straight, extra):
    a = straight(RESUME + extra)
    b = _run(tmp_path, "restart", RESUME + extra + ["--fail-at-step", "4", "--auto-restart", "2"])
    _assert_bit_identical(_final_state(a, 6), _final_state(b, 6))
    assert "rng" in _final_state(b, 6)
    assert _summary(a) == _summary(b)


def test_bitexact_resume_with_fleet_shrink(tmp_path, monkeypatch):
    """A crash that also shrinks the fleet (2 data shards -> 1) replans the
    same logical batch into deeper accumulation and lands on the final
    state of the uninterrupted 2-shard run."""
    base = ["--steps", "6", "--batch", "4", "--ckpt-every", "2",
            "--elastic-max-per-shard", "2", "--clip-policy", "quantile"]
    monkeypatch.setenv("REPRO_ELASTIC_SHARDS", "2")
    a = _run(tmp_path, "fleet2", base)
    assert _summary(a)["data_shards"] == 2 and _summary(a)["accumulation_steps"] == 2
    monkeypatch.setenv("REPRO_ELASTIC_SHARDS", "2")
    b = _run(tmp_path, "shrunk", base + ["--inject", "shrink@4:1", "--auto-restart", "2"])
    assert os.environ["REPRO_ELASTIC_SHARDS"] == "1"
    s = _summary(b)
    assert (s["data_shards"], s["logical_batch"], s["microbatch"],
            s["accumulation_steps"]) == (1, 4, 2, 2)
    _assert_bit_identical(_final_state(a, 6), _final_state(b, 6))
    assert _summary(a)["epsilon"] == s["epsilon"]


def test_torn_checkpoint_recovery_end_to_end(tmp_path, straight):
    """The crash-time checkpoint (step 3, written on the way out) is torn:
    the restart falls back to step 2 and recomputes step 3 bit for bit."""
    a = straight(RESUME + ["--clip-policy", "fixed"])
    b = _run(tmp_path, "torn", RESUME + ["--clip-policy", "fixed", "--inject",
                                         "crash@3,torn@3", "--auto-restart", "2"])
    restored = [e for e in read_jsonl(b / "events.jsonl") if e["kind"] == "checkpoint_restored"]
    assert [(e["step"], e["fell_back"]) for e in restored] == [(2, True)]
    _assert_bit_identical(_final_state(a, 6), _final_state(b, 6))
    assert _summary(a)["epsilon"] == _summary(b)["epsilon"]


def test_sigterm_preemption_checkpoints_and_exits_zero(tmp_path):
    d = tmp_path / "preempt"
    prev = signal.getsignal(signal.SIGTERM)
    assert train.main(ARCH + ["--steps", "20", "--batch", "2", "--ckpt-dir", str(d),
                              "--ckpt-every", "50", "--inject", "sigterm@1"]) == 0
    preempted_at = latest_step(d)
    assert preempted_at is not None and preempted_at < 20
    assert signal.getsignal(signal.SIGTERM) == prev
    assert train.main(ARCH + ["--steps", "3", "--batch", "2", "--ckpt-dir", str(d),
                              "--resume"]) == 0
    assert latest_step(d) == 3


# -- supervisor, refusals, plans -------------------------------------------
def test_retry_classification():
    assert train.is_retryable_failure(InjectedCrash("boom"))
    assert train.is_retryable_failure(RuntimeError("transient"))
    assert train.is_retryable_failure(OSError("storage blip"))
    assert not train.is_retryable_failure(ValueError("bad config"))
    assert not train.is_retryable_failure(AssertionError("invariant"))
    assert not train.is_retryable_failure(PlanConsensusError("ranks diverge"))


def test_config_error_burns_no_restart_and_consensus_refused(tmp_path, monkeypatch):
    calls = []
    real = train.run_once

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(train, "run_once", counting)
    with pytest.raises(ValueError, match="divide"):
        train.main(ARCH + ["--steps", "4", "--batch", "4", "--data-shards", "3",
                           "--auto-restart", "5", "--ckpt-dir", str(tmp_path / "cfg")])
    assert len(calls) == 1
    # --consensus runs (a one-process fleet agreement) and a plan that fails
    # the fleet's validity gate is a config error: no restart burned either
    assert train.main(ARCH + ["--steps", "1", "--consensus"]) == 0
    stale = tmp_path / "stale.json"
    stale.write_text(_stale_plan_json())
    calls.clear()
    with pytest.raises(PlanConsensusError, match="fingerprint"):
        train.main(ARCH + ["--steps", "2", "--consensus", "--plan", str(stale),
                           "--auto-restart", "3", "--ckpt-dir", str(tmp_path / "stale")])
    assert len(calls) == 1


def _stale_plan_json() -> str:
    from repro_torch.tuner.plan import ClipPlan

    return ClipPlan(fingerprint="another-model", device="cpu:cpu", branches=(),
                    bk_branches=(), timings=(), arch="yi-6b").to_json()


def test_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])


def test_tune_plan_and_mode_auto_with_accumulation(tmp_path):
    """``--tune`` certifies a physical batch of 2 (hi cap) under a logical
    batch of 4: two accumulation microsteps.  The written plan drives a
    second run through ``--plan`` and ``--mode auto``, with the same layout
    and the plan's recommended mode."""
    plan = tmp_path / "plan.json"
    a = _run(tmp_path, "tune", ["--steps", "2", "--batch", "4", "--tune", "--tune-hi-cap", "2",
                                "--plan", str(plan)])
    assert plan.exists()
    assert (_summary(a)["microbatch"], _summary(a)["accumulation_steps"]) == (2, 2)
    b = _run(tmp_path, "auto", ["--steps", "2", "--batch", "4", "--plan", str(plan),
                                "--mode", "auto", "--tune-hi-cap", "2"])
    s = _summary(b)
    assert (s["microbatch"], s["accumulation_steps"], s["logical_batch"]) == (2, 2, 4)
    adopted = [e for e in read_jsonl(b / "events.jsonl") if e["kind"] == "plan_adopted"]
    want = json.loads(plan.read_text())
    assert adopted[-1]["source"] == "plan" and adopted[-1]["mode"] in ("mixed_ghost", "bk_mixed")
    assert adopted[-1]["plan_device"] == want["device"] == "cpu:cpu"
