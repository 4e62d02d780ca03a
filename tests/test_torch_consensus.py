"""The port's fleet agreement (``repro_torch.tuner.consensus``) against the
JAX package's, a live fleet over ``torch.distributed``, and the train CLI
as a 2-rank fleet under ``torch.distributed.run``.

- ``agree()`` on the JAX tests' simulated fleets (one kind, mixed kinds,
  the median tie-break, the minimum batch, a kind without a certificate,
  fingerprint, policy and duplicate-plan mismatches): the same reports
  through both packages adopt the same plan bytes and hash, or both raise.
  ``verify_adopted`` refuses a tampered hash, a stale fingerprint and a
  foreign policy in both.  Exact: the protocol is pure.
- Two spawned gloo ranks (``tests/torch_fleet_cases.py``, the counterpart
  of ``tests/distributed/_worker.py``) gather through the rendezvous
  store, elect rank 0, adopt one byte-identical plan, fail a divergent
  value on both ranks and fail a missing peer within the bounded timeout.
- The train CLI on 2 CPU ranks with ``--consensus`` (reduced Whisper,
  ``bk_mixed``, quantile policy, Poisson masks) against the one-process
  CLI: per-step losses 1e-5 relative, the checkpoint's leaf names and
  shapes equal and every leaf within 1e-5 of its largest entry, the
  summaries equal; a 2-rank run crashed at step 3 and auto-restarted lands
  bit-identical to the straight 2-rank run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.tuner import consensus as jcons
from repro.tuner.plan import ClipPlan as JClipPlan
from repro_torch.tuner import consensus as tcons
from repro_torch.tuner.plan import ClipPlan as TClipPlan
from torch_dist import free_port, run_ranks
from torch_fleet_cases import consensus_fleet
from torch_threads import torch_threads_per_worker  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
FP = "fp0123456789abcd"


def _plan(device: str, scale: float = 1.0, **kw) -> JClipPlan:
    names = ["f1/out", "f2/out"]
    return JClipPlan(
        fingerprint=FP, device=device,
        branches=tuple((n, "ghost") for n in names),
        bk_branches=tuple((n, "instantiate") for n in names),
        timings=tuple((n, 10.0 * scale, 20.0 * scale, 5.0 * scale, 4.0 * scale, 30.0 * scale)
                      for n in names),
        arch="twolayer", **kw)


def _reports(rows):
    """(process, device, plan or None, cost, fingerprint, policy) rows ->
    (JAX reports, port reports) of the same payloads."""
    payloads = [dict(process_index=i, device=d, fingerprint=fp,
                     plan_json=None if p is None else p.to_json(), step_cost_us=c, policy=pol)
                for i, d, p, c, fp, pol in rows]
    return ([jcons.RankReport.from_payload(p) for p in payloads],
            [tcons.RankReport.from_payload(p) for p in payloads])


def _row(i, device, plan=None, cost=None, fp=FP, policy="fixed:1.0"):
    return (i, device, plan, cost, fp, policy)


GPU_A, GPU_B = "gpu:NVIDIA H100 80GB HBM3", "gpu:NVIDIA A100-SXM4-80GB"
FLEETS = {
    "one_kind": [_row(0, "cpu:cpu", _plan("cpu:cpu")), _row(1, "cpu:cpu"), _row(2, "cpu:cpu")],
    "mixed_kinds": [_row(0, GPU_B, _plan(GPU_B, 2.0)), _row(1, GPU_A, _plan(GPU_A, 1.0)),
                    _row(2, GPU_B), _row(3, GPU_A)],
    "median_tie_break": [_row(0, GPU_B, _plan(GPU_B), 50.0), _row(1, GPU_A, _plan(GPU_A), 50.0),
                         _row(2, GPU_B, None, 10.0), _row(3, GPU_A, None, 90.0)],
    "min_batch": [_row(0, GPU_A, _plan(GPU_A, 1.0, physical_batch=8, logical_batch=16,
                                       accumulation_steps=2, budget_bytes=1 << 30)),
                  _row(1, GPU_B, _plan(GPU_B, 3.0, physical_batch=4, logical_batch=16,
                                       accumulation_steps=4, budget_bytes=1 << 30))],
    "one_kind_uncertified": [_row(0, GPU_A, _plan(GPU_A, 1.0, physical_batch=8)),
                             _row(1, GPU_B, _plan(GPU_B, 3.0))],
}
REFUSED = {
    "fingerprint_mismatch": [_row(0, "cpu:cpu", _plan("cpu:cpu")),
                             _row(1, "cpu:cpu", fp="another")],
    "policy_mismatch": [_row(0, "cpu:cpu", _plan("cpu:cpu")),
                        _row(1, "cpu:cpu", policy="quantile:0.5")],
    "duplicate_plans_differ": [_row(0, "cpu:cpu", _plan("cpu:cpu")),
                               _row(1, "cpu:cpu", _plan("cpu:cpu", 2.0))],
    "no_plan_for_a_kind": [_row(0, "cpu:cpu", _plan("cpu:cpu")), _row(1, GPU_A)],
    "no_reports": [],
}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_agree_adopts_the_jax_bytes(name):
    jreports, treports = _reports(FLEETS[name])
    jplan, tplan = jcons.agree(jreports), tcons.agree(treports)
    assert tplan.to_json() == jplan.to_json()
    assert tplan.consensus_bytes() == jplan.consensus_bytes()
    assert tplan.consensus_hash() == jplan.consensus_hash() == tplan.agreed_hash
    assert tplan.agreed_ranks == len(treports)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_agree_refuses_where_jax_refuses(name):
    jreports, treports = _reports(REFUSED[name])
    with pytest.raises(jcons.PlanConsensusError) as je:
        jcons.agree(jreports)
    with pytest.raises(tcons.PlanConsensusError) as te:
        tcons.agree(treports)
    assert str(te.value) == str(je.value)


def test_elect_leaders_and_simulated_fleet_agree():
    """The JAX tests' fake all-gather: a 2-rank fleet adopts one plan on
    both ranks; the certify phase catches a diverging hash."""
    devices = {3: GPU_A, 1: GPU_B, 0: GPU_A}
    assert tcons.elect_leaders(devices) == jcons.elect_leaders(devices)
    leader = TClipPlan.from_json(_plan("cpu:cpu").to_json())
    payloads = {"agree": [], "certify": []}

    def gather(p):
        return payloads[p["phase"]]

    for idx, plan in ((0, leader), (1, None)):
        payloads["agree"].append(dict(tcons.RankReport(
            idx, "cpu:cpu", FP, None if plan is None else plan.to_json(),
            None if plan is None else tcons.plan_step_cost_us(plan), "fixed:1.0").to_payload(),
            phase="agree"))
    adopted = tcons.agree([tcons.RankReport.from_payload(p) for p in payloads["agree"]])
    payloads["certify"] = [{"phase": "certify", "process_index": i,
                            "hash": adopted.consensus_hash()} for i in (0, 1)]
    tcons.certify_fleet_hash(adopted, gather_fn=gather, process_index=0)
    payloads["certify"][1]["hash"] = "0" * 16
    with pytest.raises(tcons.PlanConsensusError, match="diverge"):
        tcons.certify_fleet_hash(adopted, gather_fn=gather, process_index=0)
    ok, mb = tcons.reconcile_recertification(
        True, 8, gather_fn=lambda p: [p, dict(p, process_index=1, physical_batch=4)],
        process_index=0)
    assert (ok, mb) == jcons.reconcile_recertification(
        True, 8, gather_fn=lambda p: [p, dict(p, process_index=1, physical_batch=4)],
        process_index=0) == (True, 4)


def test_verify_adopted_refuses_like_jax(monkeypatch):
    """A tampered hash, a stale fingerprint and a foreign policy."""
    monkeypatch.setattr(jcons, "shape_fingerprint", lambda metas: FP)
    monkeypatch.setattr(tcons, "shape_fingerprint", lambda metas: FP)
    jplan = jcons.agree(_reports(FLEETS["one_kind"])[0])
    tplan = TClipPlan.from_json(jplan.to_json())
    jcons.verify_adopted(jplan, {}, device="cpu:cpu", policy_fingerprint="fixed:1.0")
    tcons.verify_adopted(tplan, {}, device="cpu:cpu", policy_fingerprint="fixed:1.0")
    cases = [
        (dict(agreed_hash="f" * 16), "cpu:cpu", None),  # edited after certification
        (dict(fingerprint="stale"), "cpu:cpu", None),
        (dict(policy_fingerprint="quantile:0.5"), "cpu:cpu", "fixed:1.0"),
        ({}, GPU_A, None),  # a device that never ratified it
    ]
    for change, dev, pol in cases:
        with pytest.raises(jcons.PlanConsensusError) as je:
            jcons.verify_adopted(dataclasses.replace(jplan, **change), {}, device=dev,
                                 policy_fingerprint=pol)
        with pytest.raises(tcons.PlanConsensusError) as te:
            tcons.verify_adopted(dataclasses.replace(tplan, **change), {}, device=dev,
                                 policy_fingerprint=pol)
        # the same refusal; the port says "run" where the JAX package says "trace"
        assert str(te.value).split(";")[0] == str(je.value).split(";")[0]


def test_default_gather_is_the_identity_on_one_process():
    assert tcons.default_gather({"x": 1}) == [{"x": 1}]


def test_live_two_process_fleet():
    """Mirrors tests/distributed/test_two_process.py's assertions."""
    r0, r1 = run_ranks(consensus_fleet, 2, timeout=240)
    assert r0["n"] == r1["n"] == 2
    for r in (r0, r1):
        assert r["gather_tokens"] == ["tok-0", "tok-1"]
        assert r["gather_ranks"] == [0, 1]
    assert r0["is_leader"] is True and r1["is_leader"] is False
    assert r0["leaders"] == r1["leaders"] and r0["fleet"] == r1["fleet"]
    assert len(r0["fleet"]) == 2
    assert r0["plan_json"] == r1["plan_json"]
    assert r0["plan_hash"] == r1["plan_hash"]
    assert r0["agreed_ranks"] == r1["agreed_ranks"] == 2
    assert r0["leader_process"] == r1["leader_process"] == 0
    for r in (r0, r1):
        assert r["certify_uniform_ok"] is True
        assert r["divergence_detected"] is True
    assert "did not publish" in r0["missing_peer"]


# -- the train CLI as a fleet ------------------------------------------------
ARGV = ["--arch", "whisper-large-v3", "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "4", "--seq", "8", "--mode", "bk_mixed", "--clip-policy", "quantile",
        "--poisson", "--sample-size", "8", "--ckpt-every", "2", "--log-every", "1"]


def _fleet_cli(ckpt: pathlib.Path, *extra) -> subprocess.Popen:
    """Starts the train CLI on two CPU ranks under ``torch.distributed.run``;
    ``_finish`` waits for it."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS=str(max(1, int(os.environ.get("OMP_NUM_THREADS", "2")) // 2)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "-m", "repro_torch.launch.train", *ARGV, "--consensus", "--ckpt-dir", str(ckpt),
           *extra]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen) -> str:
    """Waits for a ``_fleet_cli`` run (killed after 300 s); its exit code
    and output's tail, as ``"rc: ..."``."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return f"{proc.returncode}: {out[-4000:]}{err[-4000:]}"


def _losses(ckpt: pathlib.Path, rank: int = 0) -> dict:
    out = {}
    for line in (ckpt / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec.get("kind") == "train_step" and rec["rank"] == rank:
            out[rec["step"]] = rec["loss"]
    return out


def _npz(path: pathlib.Path) -> dict:
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files}


def test_train_cli_fleet_matches_one_process_and_resumes(tmp_path):
    from repro_torch.launch import train

    one, two, crashed = tmp_path / "one", tmp_path / "two", tmp_path / "crashed"
    # both fleets run at once, beside the one-process run
    fleets = [_fleet_cli(two), _fleet_cli(crashed, "--inject", "crash@3", "--auto-restart", "1")]
    try:
        assert train.main([*ARGV, "--ckpt-dir", str(one)]) == 0
    finally:
        ended = [_finish(proc) for proc in fleets]
    for e in ended:
        assert e.startswith("0: "), e

    want = _losses(one)
    assert sorted(want) == [1, 2, 3, 4]
    for rank in (0, 1):
        got = _losses(two, rank)
        assert got.keys() == want.keys()
        for s, v in want.items():
            assert abs(got[s] - v) <= 1e-5 * abs(v), (rank, s)
    a, b = _npz(one / "step_4.npz"), _npz(two / "step_4.npz")
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert b[k].shape == v.shape and b[k].dtype == v.dtype, k
        if v.dtype.kind == "f" and v.size:
            assert float(np.abs(b[k] - v).max()) <= 1e-5 * max(float(np.abs(v).max()), 1e-30), k
    s1, s2 = (json.loads((d / "summary.json").read_text()) for d in (one, two))
    assert s1 == s2

    c = _npz(crashed / "step_4.npz")
    assert c.keys() == b.keys()
    for k, v in b.items():
        assert np.array_equal(c[k], v), k
    assert json.loads((crashed / "summary.json").read_text()) == s2
    events = [json.loads(x) for x in (crashed / "events.jsonl").read_text().splitlines()]
    assert {e["rank"] for e in events if e["kind"] == "restart_attempt"} == {0, 1}
