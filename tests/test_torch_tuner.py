"""repro_torch.tuner and the plan's knobs, held against ``tests/test_tuner.py``
and against the JAX package.

One case here for each test of the JAX tuner that has a counterpart in the
port (same name, ``test_`` prefix; the two built on XLA's compile-time
memory analysis, ``test_max_batch_by_memory_monotone_model`` and
``test_max_batch_trial_converges_to_memory_model``, have none: the port's
memory model is the line through its own trials' device peaks and only
pre-filters trials on the card).  Then across the packages: the shape fingerprints of one model
agree, a plan made in JAX and carried by ``interop.plan_from_jax`` gives
both packages the same norms and clipped sums (1e-5), and the time rule
(Remark 4.1) picks the same branch per tap on VGG-19's and BEiT-Large's
full-width taps (meta discovery only, on abstract shapes: JAX's eval_shape
and torch's ``meta`` device, so nothing is allocated).  Inputs come from
numpy or a seeded generator; tolerances are stated per test.

The CLI (``python -m repro_torch.tuner``, ``tuner/cli.py``) on the CPU with
a reduced LM: a plan is written and ``PrivacyEngine.use_plan`` runs a step
under it equal to the analytic step (1e-6), ``--import-plan`` adopts it,
a plan with another fingerprint, device or an agreement hash that does not
re-verify exits 1, and ``--consensus`` is refused naming the slice that
brings it.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_native import BEIT_LARGE as JBEIT_LARGE
from repro.configs.paper_native import VIT_BASE as JVIT_BASE
from repro.core import clipping as jclip
from repro.core.decision import decide as jdecide
from repro.models import cnn as jcnn
from repro.models import vit as jvit
from repro.tuner import plan as jplan
from repro_torch import interop
from repro_torch.configs.paper_native import BEIT_LARGE, VIT_BASE
from repro_torch.core.clipping import ClipConfig, discover_meta, dp_value_and_clipped_grad
from repro_torch.core.decision import decide, ghost_is_cheaper
from repro_torch.core.engine import PrivacyEngine
from repro_torch.core.taps import Ctx, TapMeta
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as tsteps
from repro_torch.models import cnn as tcnn
from repro_torch.models import vit as tvit
from repro_torch.nn.module import Dense
from repro_torch.optim import adam, sgd
from repro_torch.optim import schedules as tsched
from repro_torch.tuner import (
    ClipPlan,
    MeasureConfig,
    build_plan,
    certify_max_batch,
    derive_accumulation,
    device_string,
    find_max_physical_batch,
    max_batch_by_trial,
    remeasure_at_batch,
    shape_fingerprint,
)
from repro_torch.tuner import max_batch as tmb
from repro_torch.tuner.measure import KERNEL_OPS_BY_KIND, measure_tap
from repro_torch.tuner.plan import KERNEL_IMPLS, KERNEL_OPS, PLAN_VERSION, tap_signature
from repro_torch.utils.tree import flatten_dict, tree_map, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

CPU = torch.device("cpu")
FAST = MeasureConfig(repeats=1, warmup=1)


def _meta(kind="matmul", T=8, D=16, p=4, batch=2):
    return TapMeta(kind=kind, T=T, D=D, p=p, s_shape=(batch, T, p), s_dtype=torch.float32,
                   param_path="w", batch_size=batch)


def _max_diff(a, b) -> float:
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert fa.keys() == fb.keys()
    return max(float((fa[k] - fb[k]).abs().max()) for k in fa)


# ---------------------------------------------------------------- decision --
def test_eq41_tie_prefers_instantiate():
    T, p, D = 4, 2, 16
    assert 2 * T * T == p * D
    assert not ghost_is_cheaper(T, D, p, by="space")
    assert decide(_meta(T=T, D=D, p=p), mode="mixed_ghost") == "instantiate"


def test_remark41_time_variant_differs_from_space():
    assert ghost_is_cheaper(2, 16, 1, by="space")
    assert not ghost_is_cheaper(2, 16, 1, by="time")
    m = _meta(T=2, D=16, p=1)
    assert decide(m, mode="mixed_ghost", by="space") == "ghost"
    assert decide(m, mode="mixed_ghost", by="time") == "instantiate"


def test_plan_override_wins_over_analytic_rule():
    m = _meta(T=1, D=64, p=64)
    assert decide(m, mode="mixed_ghost") == "ghost"
    assert decide(m, mode="mixed_ghost", override="instantiate") == "instantiate"
    assert decide(m, mode="mixed_ghost", override="ghost") == "ghost"
    with pytest.raises(ValueError):
        decide(m, mode="mixed_ghost", override="banana")


def test_override_never_wins_over_forced_kinds():
    assert decide(_meta(kind="embedding"), override="instantiate") == "ghost"
    assert decide(_meta(kind="scale"), override="ghost") == "instantiate"


def test_override_never_wins_over_reference_modes():
    m = _meta(T=1, D=64, p=64)
    assert decide(m, mode="ghost", override="instantiate") == "ghost"
    assert decide(m, mode="fastgradclip", override="ghost") == "instantiate"


def test_bk_branch_rule_is_bank_size_driven():
    assert decide(_meta(T=1, D=64, p=4096), mode="bk_mixed") == "ghost"
    assert decide(_meta(T=1024, D=27, p=32), mode="bk_mixed") == "instantiate"
    m = _meta(T=16, D=32, p=32)
    assert decide(m, mode="mixed_ghost") == "ghost"
    assert decide(m, mode="bk_mixed") == "instantiate"
    conv_meta = dataclasses.replace(_meta(T=64, D=576, p=64, batch=2),
                                    a_shape=(2, 16, 16, 64), a_dtype=torch.float32)
    assert decide(conv_meta, mode="bk_mixed") == "ghost"
    assert decide(_meta(T=64, D=576, p=64), mode="bk_mixed") == "instantiate"


def test_bk_override_wins_and_stays_exact_branchwise():
    m = _meta(T=1, D=64, p=4096)
    assert decide(m, mode="bk_mixed", override="instantiate") == "instantiate"
    with pytest.raises(ValueError):
        decide(m, mode="bk_mixed", override="banana")


# -------------------------------------------------------------------- plan --
def _tiny_metas():
    return {
        "a/out": _meta(T=8, D=16, p=4),
        "b/out": _meta(T=2, D=32, p=32),
        "emb/out": _meta(kind="embedding", T=8, D=1, p=16),
    }


def test_clipplan_json_round_trip(tmp_path):
    metas = _tiny_metas()
    plan = ClipPlan(
        fingerprint=shape_fingerprint(metas), device=device_string(CPU),
        branches=(("a/out", "instantiate"), ("b/out", "ghost")),
        bk_branches=(("a/out", "instantiate"), ("b/out", "instantiate")),
        physical_batch=64, logical_batch=256, accumulation_steps=4,
        measured_at_physical=True, arch="tiny",
        timings=(("a/out", 10.0, 5.0, 9.0, 6.0, 20.0), ("b/out", 3.0, 7.0, 8.0, 4.0, 12.0)),
        devices=("gpu:other",), agreed_hash="abc", agreed_ranks=2, leader_process=0,
    )
    path = str(tmp_path / "plan.json")
    plan.save(path)
    loaded = ClipPlan.load(path)
    assert loaded == plan  # the consensus provenance fields round-trip too
    assert loaded.version == PLAN_VERSION == jplan.PLAN_VERSION
    assert loaded.branch_map() == {"a/out": "instantiate", "b/out": "ghost"}
    assert loaded.branch_map("bk_mixed") == {"a/out": "instantiate", "b/out": "instantiate"}
    raw = json.loads(open(path).read())
    assert raw["physical_batch"] == 64 and raw["measured_at_physical"] is True
    # the same JSON schema as the JAX package's, key for key
    jraw = json.loads(jplan.ClipPlan(fingerprint="f", device="d").to_json())
    assert set(raw) == set(jraw)
    assert KERNEL_OPS == dispatch.OPS and KERNEL_IMPLS == dispatch.IMPLS


def test_clipplan_mode_costs_and_recommendation():
    plan = ClipPlan(fingerprint="f", device="d",
                    timings=(("a", 10.0, 5.0, 9.0, 6.0, 20.0), ("b", 3.0, 7.0, 8.0, 4.0, 12.0)))
    assert plan.mode_cost_us("mixed_ghost") == 40.0
    assert plan.mode_cost_us("bk_mixed") == 10.0
    assert plan.recommended_mode() == "bk_mixed"
    assert ClipPlan(fingerprint="f", device="d").recommended_mode() == "mixed_ghost"


def test_clipplan_rejects_bad_json():
    for bad in ({"version": 99}, {"version": 1}, {"version": 2, "branches": [["a", "banana"]]},
                {"version": 2, "bk_branches": [["a", "banana"]]}):
        with pytest.raises(ValueError):
            ClipPlan.from_json(json.dumps({"fingerprint": "x", "device": "y", **bad}))


def test_stale_plan_rejected_falls_back_to_analytic(caplog):
    metas = _tiny_metas()
    good = ClipPlan(fingerprint=shape_fingerprint(metas), device=device_string(CPU),
                    branches=(("a/out", "instantiate"),),
                    bk_branches=(("a/out", "ghost"), ("b/out", "ghost")))
    assert good.overrides_for(metas, CPU) == {"a/out": "instantiate"}
    assert good.overrides_for(metas, CPU, mode="bk_mixed") == {"a/out": "ghost", "b/out": "ghost"}
    stale = dataclasses.replace(good, fingerprint="deadbeefdeadbeef")
    with caplog.at_level("WARNING"):
        assert stale.overrides_for(metas, CPU) == {}
    assert "falling back to the analytic decision" in caplog.text  # logged
    assert dataclasses.replace(good, device="tpu:TPU v9").overrides_for(metas, CPU) == {}
    # a GPU plan is not a CPU plan
    assert dataclasses.replace(good, device="gpu:NVIDIA H100 80GB HBM3").overrides_for(
        metas, CPU) == {}
    other = dict(metas, **{"a/out": _meta(T=8, D=32, p=4)})
    assert shape_fingerprint(other) != shape_fingerprint(metas)
    rebatched = dict(metas, **{"a/out": _meta(T=8, D=16, p=4, batch=64)})
    assert shape_fingerprint(rebatched) == shape_fingerprint(metas)


# --------------------------------------------------------------- max batch --
def test_find_max_physical_batch_is_exact():
    for threshold in (1, 2, 37, 64, 100):
        assert find_max_physical_batch(lambda b, t=threshold: b <= t, hi_cap=128) == min(
            threshold, 128)
    assert find_max_physical_batch(lambda b: False, hi_cap=128) == 0
    assert find_max_physical_batch(lambda b: True, hi_cap=128) == 128


def test_derive_accumulation_invariants():
    for logical, max_phys in [(256, 96), (256, 64), (8, 64), (7, 2), (1, 1)]:
        physical, steps = derive_accumulation(logical, max_phys)
        assert physical <= max_phys and physical * steps >= logical
        assert (steps - 1) * max_phys < logical
    with pytest.raises(ValueError):
        derive_accumulation(0, 4)
    with pytest.raises(ValueError):
        derive_accumulation(4, 0)


# --------------------------------------------- end-to-end correctness oracle --
class TwoLayer:
    """One ghost-leaning and one instantiate-leaning tap (the JAX test's)."""

    device = CPU

    def __init__(self):
        self.f1 = Dense("f1", 12, 8, device=CPU)
        self.f2 = Dense("f2", 8, 4, device=CPU)

    def init(self, generator):
        return {"f1": self.f1.init(generator), "f2": self.f2.init(generator)}

    def loss_with_ctx(self, params, batch, ctx: Ctx):
        h = torch.relu(self.f1(params["f1"], batch["x"], ctx.scope("f1")))
        out = self.f2(params["f2"], h, ctx.scope("f2"))
        return ((out - batch["y"]) ** 2).mean(dim=(1, 2))


def _two_layer_setup():
    model = TwoLayer()
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"x": torch.tensor(rng.standard_normal((4, 6, 12)), dtype=torch.float32),
             "y": torch.tensor(rng.standard_normal((4, 6, 4)), dtype=torch.float32)}
    return model, params, batch


def _flip(branch):
    return "instantiate" if branch == "ghost" else "ghost"


def _flipped_plan(metas, device):
    return ClipPlan(
        fingerprint=shape_fingerprint(metas), device=device_string(device),
        branches=tuple((n, _flip(decide(m, mode="mixed_ghost")))
                       for n, m in sorted(metas.items()) if m.kind == "matmul"),
        bk_branches=tuple((n, _flip(decide(m, mode="bk_mixed")))
                          for n, m in sorted(metas.items()) if m.kind == "matmul"),
    )


@pytest.mark.parametrize("mode", ["mixed_ghost", "mixed_ghost_taps", "bk_mixed",
                                  "bk_mixed_taps"])
def test_plan_changes_branch_not_math(mode):
    """Both branch maps inverted: the same loss, norms (1e-5) and clipped sums
    (1e-5) as the analytic rule."""
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    plan = _flipped_plan(metas, CPU)
    l1, g1, a1 = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode))(
        params, batch)
    l2, g2, a2 = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, plan=plan))(
        params, batch)
    assert float(l1) == float(l2)
    torch.testing.assert_close(a1["per_sample_norms"], a2["per_sample_norms"], rtol=0, atol=1e-5)
    assert _max_diff(g1, g2) < 1e-5


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "bk_mixed_taps"])
def test_plan_kernel_choice_changes_no_output(mode):
    """A plan's kernel map holds the device's production impl (on the CPU the
    plain versions): the outputs equal the unplanned step's; a map sending
    a tap to another device's impl is refused, never run."""
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)

    def plan_with(impl):
        return ClipPlan(fingerprint=shape_fingerprint(metas), device=device_string(CPU),
                        kernels=tuple((n, op, impl) for n, m in sorted(metas.items())
                                      for op in KERNEL_OPS_BY_KIND.get(m.kind, ())))

    l0, g0, a0 = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode))(
        params, batch)
    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode,
                                                                   plan=plan_with("torch")))
    l1, g1, a1 = fn(params, batch)
    assert float(l0) == float(l1)
    torch.testing.assert_close(a0["per_sample_norms"], a1["per_sample_norms"], rtol=0, atol=1e-5)
    assert _max_diff(g0, g1) < 1e-5
    bad = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode,
                                                                    plan=plan_with("cuda")))
    with pytest.raises(ValueError, match="plan routes tap"):
        bad(params, batch)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "bk_mixed_taps"])
def test_force_impl_wins_over_a_plans_kernel_choice(mode):
    """``force_impl`` outranks a plan's per-tap kernel map, so a yardstick
    run under it cannot be bypassed by the plan: dispatch resolves forced >
    explicit > device default.  On the CPU the plan records the plain
    versions; forcing the kernels sends the planned step's ops to them,
    and they refuse CPU tensors."""
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    plan = ClipPlan(fingerprint=shape_fingerprint(metas), device=device_string(CPU),
                    kernels=tuple((n, op, "torch") for n, m in sorted(metas.items())
                                  for op in KERNEL_OPS_BY_KIND.get(m.kind, ())))
    x = torch.zeros(2, 3)
    with dispatch.force_impl("torch"):
        assert dispatch.resolve("ghost_norm", x, impl="cuda") == "torch"
    with dispatch.force_impl(psg_contract="cuda"):
        assert dispatch.resolve("psg_contract", x, impl="torch") == "cuda"
        assert dispatch.resolve("ghost_norm", x, impl="torch") == "torch"
    fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, plan=plan))
    fn(params, batch)
    with dispatch.force_impl("cuda"), pytest.raises(ValueError, match="CUDA tensor"):
        fn(params, batch)


def test_plan_v5_kernels_round_trip_and_staleness(tmp_path):
    metas = _tiny_metas()
    plan = ClipPlan(fingerprint=shape_fingerprint(metas), device=device_string(CPU),
                    kernels=(("a/out", "ghost_norm", "torch"), ("a/out", "psg_contract", "torch"),
                             ("emb/out", "embedding_ghost_norm", "torch")))
    path = str(tmp_path / "plan.json")
    plan.save(path)
    loaded = ClipPlan.load(path)
    assert loaded == plan
    assert loaded.kernel_map() == {"a/out": {"ghost_norm": "torch", "psg_contract": "torch"},
                                   "emb/out": {"embedding_ghost_norm": "torch"}}
    assert loaded.kernels_for(metas, CPU) == loaded.kernel_map()
    assert dataclasses.replace(loaded, fingerprint="deadbeefdeadbeef").kernels_for(
        metas, CPU) == {}
    assert dataclasses.replace(loaded, device="gpu:NVIDIA H100").kernels_for(metas, CPU) == {}
    ratified = dataclasses.replace(loaded, device="gpu:NVIDIA H100",
                                   devices=(device_string(CPU),),
                                   branches=(("a/out", "ghost"),),
                                   kernels=(("a/out", "ghost_norm", "cuda"),))
    assert ratified.overrides_for(metas, CPU) == {"a/out": "ghost"}
    assert ratified.kernels_for(metas, CPU) == {}
    flipped = dataclasses.replace(loaded, kernels=(("a/out", "ghost_norm", "cuda"),)
                                  + loaded.kernels[1:])
    assert flipped.consensus_hash() != loaded.consensus_hash()
    bad = json.loads(plan.to_json())
    bad["kernels"] = [["a/out", "ghost_norm", "banana"]]
    with pytest.raises(ValueError):
        ClipPlan.from_json(json.dumps(bad))
    bad["kernels"] = [["a/out", "ghost_nrm", "torch"]]
    with pytest.raises(ValueError, match="unknown kernel op"):
        ClipPlan.from_json(json.dumps(bad))
    v4 = json.loads(plan.to_json())
    del v4["kernels"]
    v4["version"] = 4
    assert ClipPlan.from_json(json.dumps(v4)).kernels == ()


def test_build_plan_records_kernel_choices():
    """One production impl per device: recorded for every dispatchable op
    of every tap, without a race."""
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    plan = build_plan(metas, measure=FAST, arch="twolayer", device=CPU)
    kmap = plan.kernel_map()
    assert set(kmap) == {n for n, m in metas.items() if m.kind in KERNEL_OPS_BY_KIND}
    for n, ks in kmap.items():
        assert set(ks) == set(KERNEL_OPS_BY_KIND[metas[n].kind])
        assert set(ks.values()) == set(dispatch.available_impls(CPU)) == {"torch"}
    assert dispatch.available_impls(torch.zeros(1)) == ("torch",)
    assert plan.device == "cpu:cpu"


def test_measured_plan_round_trips_through_engine(tmp_path):
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    plan = build_plan(metas, measure=FAST, arch="twolayer", device=CPU)
    assert set(plan.branch_map()) == {n for n, m in metas.items() if m.kind == "matmul"}
    path = str(tmp_path / "plan.json")
    plan.save(path)
    plan = ClipPlan.load(path)
    _, g1, _ = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig())(params, batch)
    _, g2, _ = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(plan=plan))(
        params, batch)
    assert _max_diff(g1, g2) < 1e-5


def test_measure_tap_conv_times_real_bk_kernels():
    """A conv tap is timed on the port's branch code: the ghost norm on the
    raw NHWC input, the instantiate branch and the ghost book through
    their unfold, the psg bank through ``_conv_psg``."""
    from repro_torch.nn.conv import Conv2d, global_avg_pool

    conv = Conv2d("c", 3, 8, (3, 3), strides=(2, 2), padding="SAME", device=CPU)
    head = Dense("head", 8, 5, device=CPU)
    gen = torch.Generator().manual_seed(0)
    params = {"c": conv.init(gen), "head": head.init(gen)}

    def loss(params, batch, ctx):
        h = global_avg_pool(conv(params["c"], batch["image"], ctx.scope("c")))
        out = head(params["head"], h[:, None, :], ctx.scope("head"))[:, 0]
        return (out * out).sum(dim=-1)

    batch = {"image": torch.randn(2, 8, 8, 3, generator=gen)}
    metas = discover_meta(loss, params, batch)
    (conv_meta,) = [m for m in metas.values() if m.conv is not None]
    assert conv_meta.a_shape == (2, 8, 8, 3)
    t = measure_tap(conv_meta, MeasureConfig(repeats=1, warmup=1, max_rows=2), device=CPU)
    for v in (t.ghost_us, t.instantiate_us, t.bk_ghost_us, t.bk_instantiate_us,
              t.second_bwd_us):
        assert v > 0.0


def test_remeasure_at_physical_batch_closes_the_loop():
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    cfg = MeasureConfig(repeats=1, warmup=1, max_rows=2)
    plan = build_plan(metas, measure=cfg, arch="twolayer", device=CPU)
    assert not plan.measured_at_physical
    plan2 = remeasure_at_batch(plan, metas, 8, cfg, device=CPU)
    assert plan2.measured_at_physical
    assert plan2.fingerprint == plan.fingerprint and plan2.matches(metas, CPU)
    assert set(dict(plan2.branches)) == set(dict(plan.branches))
    assert set(dict(plan2.bk_branches)) == set(dict(plan.bk_branches))


def _engine(model):
    return PrivacyEngine(loss_with_ctx=model.loss_with_ctx, batch_size=4, sample_size=1000,
                         steps=10, max_grad_norm=1.0, noise_multiplier=1.0, device=CPU)


def test_engine_tune_remeasures_at_tuned_batch(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path))
    model, params, batch = _two_layer_setup()
    eng = _engine(model)
    plan = eng.tune(params, batch, arch="twolayer", plan_path=None, use_cache=False,
                    measure=FAST, budget_bytes=1 << 30, hi_cap=16)
    assert plan.physical_batch == 16 and plan.measured_at_physical
    assert (plan.logical_batch, plan.accumulation_steps) == (4, 1)
    assert eng.plan == plan and eng.clipped_grad_fn().cfg.plan == plan
    fields = eng.plan_event_fields()
    assert fields["source"] == "plan" and fields["physical_batch"] == 16
    assert fields["branches"] == plan.branch_map("mixed_ghost")
    assert _engine(model).plan_event_fields()["source"] == "analytic"
    # one process: consensus=True adopts the plan stamped by a one-rank fleet
    # (the JAX test_engine_tune_consensus_single_process)
    agreed = eng.tune(params, batch, arch="twolayer", plan_path=None, use_cache=False,
                      search_max_batch=False, measure=FAST, consensus=True)
    assert (agreed.agreed_ranks, agreed.leader_process, agreed.devices) == (1, 0, ("cpu:cpu",))
    assert agreed.agreed_hash == agreed.consensus_hash() and eng.plan == agreed
    from repro_torch.tuner.consensus import verify_adopted

    verify_adopted(agreed, discover_meta(model.loss_with_ctx, params, batch), device=CPU)


def test_engine_tune_cache_hit(tmp_path, monkeypatch):
    """A second tune() for the same (arch, device, shapes) skips profiling."""
    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path))
    model, params, batch = _two_layer_setup()
    eng = _engine(model)
    p1 = eng.tune(params, batch, arch="twolayer", search_max_batch=False, measure=FAST)
    p2 = eng.tune(params, batch, arch="twolayer", search_max_batch=False, measure=FAST)
    assert p1 == p2 and eng.plan == p1
    assert p1.policy_fingerprint == eng.clip_policy.fingerprint()
    p3 = eng.tune(params, batch, arch="twolayer", search_max_batch=False, measure=FAST,
                  use_cache=False, plan_path=None)
    assert p3.fingerprint == p1.fingerprint
    # a cached certificate holds only for its budget: another one re-tunes
    p4 = eng.tune(params, batch, arch="twolayer", measure=FAST, budget_bytes=1 << 30,
                  hi_cap=8)
    assert p4.physical_batch == 8 and p4.budget_bytes == 1 << 30
    assert eng.recertify_max_batch(params, batch, hi_cap=8) == p4


def test_noise_finalize_non_private_matches_train_step():
    """Finalize must not noise or rescale non_private runs."""
    model, params, batch = _two_layer_setup()
    opt = adam()
    dp = tsteps.DPTrainConfig(clipping_mode="non_private", noise_multiplier=123.0,
                              logical_batch=4)
    fin = tsteps.make_noise_finalize(opt, tsched.constant(1e-3), dp)
    grads = tree_map(torch.ones_like, params)

    def state():
        return {"params": tree_map(torch.clone, params), "opt": opt.init(params), "step": 0,
                "rng": torch.Generator().manual_seed(0)}

    assert _max_diff(fin(state(), grads)["params"], fin(state(), grads)["params"]) == 0.0


def test_max_batch_trial_survives_simulated_oom():
    """The ladder reports "does not fit" on a simulated torch.OutOfMemoryError
    and keeps the process alive; any other error propagates."""
    model, params, batch = _two_layer_setup()
    grad_fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig())
    calls = []

    def runner(b):
        calls.append(b)
        if b > 6:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    assert max_batch_by_trial(grad_fn, params, batch, budget_bytes=None, hi_cap=64,
                              runner=runner) == 6
    assert calls.count(8) == 2 and calls.count(7) == 2
    assert tmb.is_oom_error(RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"))
    assert tmb.is_oom_error(MemoryError())
    assert not tmb.is_oom_error(RuntimeError("CUDA error: an illegal memory access"))
    assert not tmb.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))

    def broken(b):
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        max_batch_by_trial(grad_fn, params, batch, budget_bytes=None, hi_cap=4, runner=broken)


def test_max_batch_trial_retries_transient_oom():
    failed_once = set()

    def flaky(b):
        if b not in failed_once:
            failed_once.add(b)
            raise torch.OutOfMemoryError("CUDA out of memory")

    assert tmb.trial_survives(flaky, 8, attempts=2)

    def always(b):
        raise torch.OutOfMemoryError("CUDA out of memory")

    assert not tmb.trial_survives(always, 8, attempts=2)


def test_certify_max_batch_method_selection(monkeypatch):
    """Concrete tensors certify by trial; without them nothing can be
    measured (torch has no compile-time memory model), and the reference's
    "memory" method, by argument or environment, is refused."""
    model, params, batch = _two_layer_setup()
    grad_fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig())
    assert certify_max_batch(grad_fn, params, batch, budget_bytes=1 << 34, hi_cap=8) == (
        8, "trial")
    assert certify_max_batch(grad_fn, params, batch, hi_cap=8, method="trial") == (8, "trial")
    specs = [tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
             for t in (params, batch)]
    assert not tmb.trials_available(*specs)
    for method in (None, "trial"):
        with pytest.raises(ValueError, match="concrete tensors"):
            certify_max_batch(grad_fn, specs[0], specs[1], hi_cap=8, method=method)
    with pytest.raises(ValueError, match="by trial only"):
        certify_max_batch(grad_fn, params, batch, hi_cap=8, method="memory")
    monkeypatch.setenv("REPRO_MAX_BATCH_METHOD", "memory")
    with pytest.raises(ValueError, match="by trial only"):
        certify_max_batch(grad_fn, params, batch, budget_bytes=1 << 34, hi_cap=8)
    # the measured model: the line through the two largest trials' peaks
    assert tmb.extrapolate({}, 8) is None and tmb.extrapolate({4: 100}, 8) is None
    assert tmb.extrapolate({1: 10, 2: 20, 4: 100}, 8) == 100 + 40 * 4
    assert tmb.extrapolate({2: 50, 4: 50}, 64) == 50  # never a negative slope


def test_remeasure_at_batch_reraces_stale_kernel_winners():
    """Kernel choices recorded at the probe batch are chosen again at the
    certified batch: a poisoned map comes back as the device's impl."""
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    cfg = MeasureConfig(repeats=1, warmup=1, max_rows=2)
    plan = build_plan(metas, measure=cfg, arch="twolayer", device=CPU)
    assert plan.kernels
    stale = dataclasses.replace(plan, kernels=tuple((n, op, "cuda") for n, op, _ in plan.kernels))
    fresh = remeasure_at_batch(stale, metas, 8, cfg, device=CPU)
    assert fresh.measured_at_physical
    assert {(n, op) for n, op, _ in fresh.kernels} == {(n, op) for n, op, _ in plan.kernels}
    assert all(impl == "torch" for _, _, impl in fresh.kernels)


def test_accum_microsteps_match_full_train_step():
    """Two microbatches of 2 through make_accum_* (with a plan in the
    DPTrainConfig, threaded into every step) equal one make_train_step on
    the logical batch of 4: parameters and optimizer state within 1e-5."""
    model, params, batch = _two_layer_setup()
    metas = discover_meta(model.loss_with_ctx, params, batch)
    opt = sgd(momentum=0.9)
    sched = tsched.constant(1e-2)
    dp = tsteps.DPTrainConfig(clipping_mode="mixed_ghost", clip_norm=1.0, noise_multiplier=0.7,
                              logical_batch=4, accumulation_steps=2,
                              plan=_flipped_plan(metas, CPU))

    def state():
        return {"params": tree_map(torch.clone, params), "opt": opt.init(params), "step": 0,
                "rng": torch.Generator().manual_seed(7)}

    full, full_metrics = tsteps.make_train_step(model, opt, sched, dp, device=CPU)(state(), batch)
    st = state()
    acc = tsteps.make_accum_init(params, 4)()
    micro = tsteps.make_accum_microstep(model, dp)
    pstate = tsteps._policy_for(dp).init_state(device=CPU)
    for i in range(2):
        acc = micro(st["params"], pstate, acc, {k: v[2 * i:2 * i + 2] for k, v in batch.items()},
                    i)
    new, metrics = tsteps.make_accum_finalize(opt, sched, dp)(st, acc)
    assert _max_diff(new["params"], full["params"]) < 1e-5
    assert _max_diff(new["opt"], full["opt"]) < 1e-5
    assert abs(float(metrics["loss"]) - float(full_metrics["loss"])) < 1e-5


# ------------------------------------------------------- across the packages --
TINY_PLAN = (8, "M", 16, "M", 32, "M")


@pytest.fixture
def tiny_vgg(monkeypatch):
    monkeypatch.setitem(jcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    monkeypatch.setitem(tcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    return "vgg_tiny"


def _image_batch(b, image, n_classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, image, image, 3)).astype(np.float32),
            "label": rng.integers(0, n_classes, size=(b,)).astype(np.int32),
            "mask": np.ones((b,), np.float32)}


def _pair(which):
    """(JAX model, port model, numpy params, numpy batch): the narrow VGG at
    16x16 or the 2-layer reduced ViT at T = 16."""
    if which == "vgg":
        jm, tm, image = jcnn.VGG("vgg_tiny", n_classes=10), tcnn.VGG("vgg_tiny", n_classes=10,
                                                                    device=CPU), 16
    else:
        jcfg = dataclasses.replace(JVIT_BASE.reduced(), n_layers=2)
        tcfg = dataclasses.replace(VIT_BASE.reduced(), n_layers=2)
        jm = jvit.ViT(jcfg, image_size=16, patch=4, n_classes=10)
        tm = tvit.ViT(tcfg, image_size=16, patch=4, n_classes=10, device=CPU)
        image = 16
    np_params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, np_params, _image_batch(3, image)


@pytest.mark.parametrize("which", ["vgg", "vit"])
def test_shape_fingerprints_agree_across_packages(which, tiny_vgg):
    jm, tm, np_params, batch = _pair(which)
    jmeta = jclip.discover_meta(jm.loss_with_ctx,
                                jax.tree_util.tree_map(jax.numpy.asarray, np_params), batch)
    tparams = interop.params_from_jax(np_params, tm.conv_weights, device=CPU)
    tmeta = discover_meta(tm.loss_with_ctx, tparams, interop.batch_from_numpy(batch, CPU))
    assert sorted(jmeta) == sorted(tmeta)
    for name in jmeta:
        assert jplan.tap_signature(name, jmeta[name]) == tap_signature(name, tmeta[name])
    assert jplan.shape_fingerprint(jmeta) == shape_fingerprint(tmeta)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed"])
@pytest.mark.parametrize("which", ["vgg", "vit"])
def test_jax_plan_carried_across_gives_equal_steps(which, mode, tiny_vgg):
    """A JAX plan flipping every matmul tap's branch (both maps), with its
    XLA kernel map, carried by ``interop.plan_from_jax``: both packages
    take it (neither falls back), and give the same norms (rtol 1e-5) and
    clipped sums (1e-5 of the largest entry) as each other."""
    jm, tm, np_params, batch = _pair(which)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    jmeta = jclip.discover_meta(jm.loss_with_ctx, jparams, batch)

    def flipped(m, mode_):
        return _flip(jdecide(m, mode=mode_))

    jp = jplan.ClipPlan(
        fingerprint=jplan.shape_fingerprint(jmeta), device=jplan.device_string(),
        branches=tuple((n, flipped(m, "mixed_ghost")) for n, m in sorted(jmeta.items())
                       if m.kind == "matmul"),
        bk_branches=tuple((n, flipped(m, "bk_mixed")) for n, m in sorted(jmeta.items())
                          if m.kind == "matmul"),
        kernels=tuple((n, "ghost_norm", "xla") for n, m in sorted(jmeta.items())
                      if m.kind == "matmul"),
    )
    assert jp.device == "cpu:cpu"
    tp = interop.plan_from_jax(jp.to_json())
    assert tp.fingerprint == jp.fingerprint and tp.branches == jp.branches
    assert tp.bk_branches == jp.bk_branches
    assert {impl for _, _, impl in tp.kernels} == {"torch"}
    tparams = interop.params_from_jax(np_params, tm.conv_weights, device=CPU)
    tbatch = interop.batch_from_numpy(batch, CPU)
    tmeta = discover_meta(tm.loss_with_ctx, tparams, tbatch)
    assert tp.overrides_for(tmeta, CPU, mode=mode) == jp.overrides_for(jmeta, mode=mode) != {}
    assert tp.kernels_for(tmeta, CPU) != {}
    # restamping on request
    assert interop.plan_from_jax(jp.to_json(), device=CPU).device == "cpu:cpu"

    jl, jg, jaux = jclip.dp_value_and_clipped_grad(
        jm.loss_with_ctx, jclip.ClipConfig(mode=mode, clip_norm=0.3, plan=jp))(jparams, batch)
    tl, tg, taux = dp_value_and_clipped_grad(
        tm.loss_with_ctx, ClipConfig(mode=mode, clip_norm=0.3, plan=tp))(tparams, tbatch)
    np.testing.assert_allclose(taux["per_sample_norms"].numpy(),
                               np.asarray(jaux["per_sample_norms"]), rtol=1e-5)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, tm.conv_weights))
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    for path, want in jflat.items():
        assert float(np.abs(tflat[path] - want).max()) <= 1e-5 * max(scale, 1.0), path


def _abstract_metas(jmodel, tmodel, image, n_classes):
    """Both packages' taps of a full-width model at batch 2 from abstract
    shapes only: JAX's eval_shape, torch's meta device (no allocation)."""
    specs = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    batch = {"image": jax.ShapeDtypeStruct((2, image, image, 3), np.float32),
             "label": jax.ShapeDtypeStruct((2,), np.int32),
             "mask": jax.ShapeDtypeStruct((2,), np.float32)}
    jmeta = jclip.discover_meta(jmodel.loss_with_ctx, specs, batch)
    convs = set(tmodel.conv_weights)
    tparams = {}
    for path, s in flatten_dict(specs).items():
        shape = tuple(s.shape)
        if path in convs:  # HWIO -> OIHW
            shape = (shape[3], shape[2], shape[0], shape[1])
        tparams[path] = torch.empty(shape, dtype=getattr(torch, str(s.dtype)), device="meta")
    tbatch = {"image": torch.empty((2, image, image, 3), device="meta"),
              "label": torch.zeros((2,), dtype=torch.int64, device="meta"),
              "mask": torch.empty((2,), device="meta")}
    tmeta = discover_meta(tmodel.loss_with_ctx, unflatten_dict(tparams), tbatch)
    return jmeta, tmeta


@pytest.mark.parametrize("which", ["vgg19", "beit_large"])
def test_time_rule_picks_the_jax_branch_per_tap(which):
    """``decision_by="time"`` (Remark 4.1): the same branch per tap as JAX's
    ``decide`` on the full-width taps, in both tuned modes, and the same
    fingerprint."""
    if which == "vgg19":
        jm, tm = jcnn.VGG("vgg19", n_classes=10), tcnn.VGG("vgg19", n_classes=10, device="meta")
        image = 32
    else:
        jm = jvit.ViT(JBEIT_LARGE, image_size=224, patch=16, n_classes=1000)
        tm = tvit.ViT(BEIT_LARGE, image_size=224, patch=16, n_classes=1000, device="meta")
        image = 224
    jmeta, tmeta = _abstract_metas(jm, tm, image, 10)
    assert sorted(jmeta) == sorted(tmeta)
    assert jplan.shape_fingerprint(jmeta) == shape_fingerprint(tmeta)
    picks = {}
    for name, m in tmeta.items():
        for mode in ("mixed_ghost", "bk_mixed"):
            for by in ("time", "space"):
                got = decide(m, mode=mode, by=by)
                assert got == jdecide(jmeta[name], mode=mode, by=by), (name, mode, by)
                picks[(mode, by)] = picks.get((mode, by), set()) | {got}
    assert picks[("mixed_ghost", "time")]  # the rule ran on every tap


# ------------------------------------------------------------------- CLI --
CLI_FAST = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--repeats", "1",
            "--warmup", "1", "--hi-cap", "8"]


@pytest.fixture(scope="module")
def cli_plan(tmp_path_factory):
    """One CLI run on reduced Yi-6B: (plan path, printed table)."""
    import contextlib
    import io

    from repro_torch.tuner import cli

    path = tmp_path_factory.mktemp("cli") / "plan.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["--arch", "yi-6b", *CLI_FAST, "--plan", str(path)]) == 0
    return path, out.getvalue()


def test_cli_writes_a_plan_the_engine_adopts(cli_plan):
    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.data.synthetic import synthetic_arch_batch

    path, table = cli_plan
    assert "ClipPlan for yi-6b on cpu:cpu" in table and "recommended mode" in table
    assert "lm_head/out" in table and "max physical batch" in table
    plan = ClipPlan.load(str(path))
    cfg = get_arch("yi-6b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = synthetic_arch_batch(cfg, batch=2, seq=16, device="cpu")
    assert plan.matches(discover_meta(model.loss_with_ctx, params, batch), CPU)
    assert plan.physical_batch and plan.physical_batch >= 2
    eng = PrivacyEngine(loss_with_ctx=model.loss_with_ctx, batch_size=2, sample_size=100,
                        steps=1, max_grad_norm=1.0, noise_multiplier=1.0, device="cpu")
    _, g0, aux0 = eng.clipped_grad_fn()(params, batch)
    eng.use_plan(plan)
    assert eng.clipped_grad_fn().cfg.plan == plan
    _, g1, aux1 = eng.clipped_grad_fn()(params, batch)
    torch.testing.assert_close(aux1["per_sample_norms"], aux0["per_sample_norms"],
                               rtol=1e-6, atol=0)
    assert _max_diff(g1, g0) <= 1e-6


def test_cli_import_plan_adopts_and_reexports(cli_plan, tmp_path, capsys):
    from repro_torch.tuner import cli

    path, _ = cli_plan
    out = tmp_path / "again.json"
    rc = cli.main(["--arch", "yi-6b", *CLI_FAST, "--import-plan", str(path),
                   "--export-plan", str(out)])
    assert rc == 0
    assert "adopted ClipPlan" in capsys.readouterr().out
    assert ClipPlan.load(str(out)) == ClipPlan.load(str(path))


@pytest.mark.parametrize("field,value", [
    ("fingerprint", "0" * 16),                 # measured for another model
    ("device", "gpu:NVIDIA H100 80GB HBM3"),    # measured on another device
    ("agreed_hash", "feedfacefeedface"),        # edited after an agreement
])
def test_cli_import_rejects_a_tampered_plan(cli_plan, tmp_path, field, value):
    from repro_torch.tuner import cli

    path, _ = cli_plan
    d = json.loads(path.read_text())
    d[field] = value
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(d))
    assert cli.main(["--arch", "yi-6b", *CLI_FAST, "--import-plan", str(bad)]) == 1
    # another arch's model does not take the plan either
    assert cli.main(["--arch", "mixtral-8x7b", *CLI_FAST, "--import-plan", str(path)]) == 1


def test_cli_refuses_consensus(tmp_path):
    """``--consensus`` now runs: on one process the written plan is the
    one-rank fleet's, stamped with its provenance (the name stays from
    when the port refused the flag)."""
    from repro_torch.tuner import cli

    out = tmp_path / "agreed.json"
    assert cli.main(["--arch", "yi-6b", *CLI_FAST, "--skip-max-batch", "--consensus",
                     "--plan", str(out)]) == 0
    plan = ClipPlan.load(str(out))
    assert (plan.agreed_ranks, plan.leader_process, plan.devices) == (1, 0, ("cpu:cpu",))
    assert plan.agreed_hash == plan.consensus_hash()
