"""The port's clipping policies, held against the JAX package's.

- each policy's factors, sensitivity and update on the same norms as JAX's
  (1e-6 relative; the quantile update without release noise, whose draws
  differ between the packages by design);
- every policy on every executor against the port's ``vmap`` under the same
  policy (5e-5, as ``test_torch_oracle.py``), and the port's ``vmap``
  against JAX's (1e-5 relative);
- ``per_layer`` on ``bk_mixed`` contracts each psg bank against its own
  group's factor row in one grouped call;
- a group split through a tap's (weight, bias) pair raises in every
  executor family;
- the quantile release composed through ``PrivacyEngine`` against
  ``repro.core.accountant`` (1e-12 absolute on epsilon).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as jclip
from repro.core.accountant import compute_epsilon as jcompute_epsilon
from repro.core.engine import PrivacyEngine as JPrivacyEngine
from repro import policies as jpol
from repro.models import cnn as jcnn
from repro_torch import interop
from repro_torch import policies as tpol
from repro_torch.core import clipping as tclip
from repro_torch.core.engine import PrivacyEngine
from repro_torch.kernels import launches
from repro_torch.models import cnn as tcnn
from repro_torch.utils.tree import flatten_dict
from test_torch_oracle import CPU, TINY_PLAN, assert_matches_vmap, pair, run_port
from torch_threads import torch_threads_per_worker  # noqa: F401

MASK = (1.0, 1.0, 0.0, 1.0)
MODES = [m for m in tclip.MODES if m not in ("vmap", "non_private")]


def _policies(pkg):
    return {
        "fixed": pkg.FixedPolicy(clip_norm=0.3),
        "automatic": pkg.AutomaticPolicy(gamma=0.01),
        # a state R other than the default: the factors read the state
        "quantile": pkg.QuantilePolicy(init_clip_norm=0.37, release_sigma=0.0),
        "per_layer": pkg.PerLayerPolicy(groups=("emb", "l1"), clip_norm=0.3),
    }


NAMES = ["fixed", "automatic", "quantile", "per_layer"]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("name", NAMES)
def test_policy_matches_jax_on_the_same_norms(name):
    rng = np.random.default_rng(3)
    paths = ["emb/e", "l1/w", "l1/b", "n/g", "l2/w"]
    path_norms2 = {p: rng.uniform(0.0, 0.5, size=8).astype(np.float32) for p in paths}
    norms = np.sqrt(sum(path_norms2.values())).astype(np.float32)
    mask = (rng.uniform(size=8) < 0.7).astype(np.float32)
    tp, jp = _policies(tpol)[name], _policies(jpol)[name]
    assert tp.fingerprint() == jp.fingerprint()
    ts, js = tp.init_state(), jp.init_state()
    assert ts.keys() == js.keys()
    tc = tp.clip_factors(torch.from_numpy(norms), ts, path_norms2={
        p: torch.from_numpy(v) for p, v in path_norms2.items()})
    jc = jp.clip_factors(jnp.asarray(norms), js, path_norms2={
        p: jnp.asarray(v) for p, v in path_norms2.items()})
    if name == "per_layer":
        assert tc.groups == jc.groups
        np.testing.assert_allclose(_np(tc.factors), _np(jc.factors), rtol=1e-6)
        np.testing.assert_allclose(_np(tc.representative), _np(jc.representative), rtol=1e-6)
        assert tc.group_index("l1/b") == jc.group_index("l1/b")
        torch.testing.assert_close(tc.for_path("l1/b"), tc.factors[tc.group_index("l1/b")])
    else:
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-6)
    np.testing.assert_allclose(float(tp.sensitivity(ts)), float(jp.sensitivity(js)), rtol=1e-6)
    tnew, tev = tp.update(ts, torch.from_numpy(norms), mask=torch.from_numpy(mask))
    jnew, jev = jp.update(js, jnp.asarray(norms), mask=jnp.asarray(mask))
    assert tev.release_sigma == jev.release_sigma
    assert tp.release_event().release_sigma == jp.release_event().release_sigma
    for key in jnew:
        np.testing.assert_allclose(_np(tnew[key]), _np(jnew[key]), rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_policy_exactness_across_executors(name, mode):
    """Every policy on every executor == the port's vmap under the policy;
    masked samples get factor 0 everywhere."""
    _, tm, _, tparams, batch = pair("mlp", mask=MASK)
    policy = _policies(tpol)[name]
    got = run_port(tm, tparams, batch, mode, policy=policy)
    assert_matches_vmap(got, run_port(tm, tparams, batch, "vmap", policy=policy),
                        (name, mode))
    assert float(got[2]["clip_factors"][2]) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_port_vmap_under_policy_matches_jax(name):
    jm, tm, jparams, tparams, batch = pair("mlp", mask=MASK)
    jfn = jclip.dp_value_and_clipped_grad(jm.loss_with_ctx, jclip.ClipConfig(
        mode="vmap", policy=_policies(jpol)[name]))
    _, jg, jaux = jax.jit(jfn)(jparams, batch)
    _, tg, taux = run_port(tm, tparams, batch, "vmap", policy=_policies(tpol)[name])
    np.testing.assert_allclose(_np(taux["clip_factors"]), _np(jaux["clip_factors"]), rtol=1e-5)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    for path, want in jflat.items():
        err = float(np.abs(_np(flatten_dict(tg)[path]) - want).max())
        assert err <= 1e-5 * scale, (name, path, err)


@pytest.mark.parametrize("mode", ["bk_mixed", "bk_mixed_taps", "mixed_ghost"])
def test_per_layer_on_the_cnn_contracts_each_bank_against_its_group(mode, monkeypatch):
    """A narrow VGG under three groups: bk_mixed's psg banks (conv0's and
    the GroupNorms') and books contract against their own groups' rows in
    one grouped call, equal to vmap; the second-backward mode runs one
    backward per group."""
    monkeypatch.setitem(jcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    monkeypatch.setitem(tcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    _, tm, _, tparams, batch = pair("vgg", mask=MASK)
    policy = tpol.PerLayerPolicy(groups=("conv0", "gn2"), clip_norm=0.3)
    launches.reset()
    got = run_port(tm, tparams, batch, mode, policy=policy)
    counts = launches.snapshot()
    assert counts["psg_contract"]["torch"] == (1 if mode == "bk_mixed" else 0)
    assert_matches_vmap(got, run_port(tm, tparams, batch, "vmap", policy=policy), mode)


@pytest.mark.parametrize("mode", ["vmap", "mixed_ghost", "bk_mixed", "mixed_ghost_taps",
                                  "bk_mixed_taps"])
def test_per_layer_group_split_raises(mode):
    """A group boundary through l1's (weight, bias) pair raises in every
    executor family, the vmap oracle included."""
    _, tm, _, tparams, batch = pair("mlp")
    policy = tpol.PerLayerPolicy(groups=("l1/w",), clip_norm=0.3)
    with pytest.raises(ValueError, match="different groups"):
        run_port(tm, tparams, batch, mode, policy=policy)


class _ProtocolGroupedPolicy(tpol.ClipPolicy):
    """A grouped policy through the base protocol only (``grouped``,
    ``groups``, ``clip_factors``): no ``group_of``."""

    name = "protocol_grouped"
    grouped = True

    def __init__(self, groups):
        self._inner = tpol.PerLayerPolicy(groups=groups, clip_norm=0.3)
        self.groups = self._inner.groups

    def init_state(self, device=None):
        return self._inner.init_state(device=device)

    def clip_factors(self, norms, state, *, path_norms2=None):
        return self._inner.clip_factors(norms, state, path_norms2=path_norms2)

    def sensitivity(self, state):
        return self._inner.sensitivity(state)


@pytest.mark.parametrize("mode", ["vmap", "mixed_ghost", "bk_mixed_taps"])
def test_executors_check_groups_through_the_policy_protocol(mode):
    """The executors check a group split from ``groups`` alone: a grouped
    policy without ``group_of`` raises on a split and otherwise matches
    per_layer."""
    _, tm, _, tparams, batch = pair("mlp", mask=MASK)
    with pytest.raises(ValueError, match="different groups"):
        run_port(tm, tparams, batch, mode, policy=_ProtocolGroupedPolicy(("l1/w",)))
    got = run_port(tm, tparams, batch, mode, policy=_ProtocolGroupedPolicy(("emb", "l1")))
    assert_matches_vmap(got, run_port(tm, tparams, batch, "vmap",
                                      policy=tpol.PerLayerPolicy(groups=("emb", "l1"),
                                                                 clip_norm=0.3)), mode)


def test_vmap_checks_its_groups_once(monkeypatch):
    """The vmap oracle traces the model's taps for the group check on its
    first call only, not on every step."""
    _, tm, _, tparams, batch = pair("mlp", mask=MASK)
    calls = []
    real = tclip.discover_meta
    monkeypatch.setattr(tclip, "discover_meta", lambda *a: calls.append(1) or real(*a))
    fn = tclip.dp_value_and_clipped_grad(tm.loss_with_ctx, tclip.ClipConfig(
        mode="vmap", policy=tpol.PerLayerPolicy(groups=("emb", "l1"), clip_norm=0.3)))
    tbatch = interop.batch_from_numpy(batch, device=CPU)
    first, second = fn(tparams, tbatch), fn(tparams, tbatch)
    assert len(calls) == 1
    torch.testing.assert_close(first[2]["per_sample_norms"], second[2]["per_sample_norms"])


def test_per_layer_threshold_budget():
    """sum R_g^2 == R^2 (equal split with the catch-all), sensitivity == R."""
    policy = tpol.PerLayerPolicy(groups=("a", "b"), clip_norm=2.0)
    st = policy.init_state()
    assert st["thresholds"].shape == (3,)
    assert abs(float(st["thresholds"].square().sum()) - 4.0) < 1e-6
    assert abs(float(policy.sensitivity(st)) - 2.0) < 1e-5
    with pytest.raises(ValueError, match="positive weight"):
        tpol.PerLayerPolicy(groups=("a",), weights=(1.0,))


def test_make_policy_filters_kwargs():
    p = tpol.make_policy("automatic", clip_norm=9.0, gamma=0.5, groups=("x",))
    assert isinstance(p, tpol.AutomaticPolicy) and p.gamma == 0.5
    assert sorted(tpol.POLICIES) == sorted(jpol.POLICIES)
    with pytest.raises(ValueError, match="unknown clip policy"):
        tpol.make_policy("nope")


def test_quantile_release_draws_from_its_generator():
    """With release noise the update needs a generator (the JAX package: a
    key), and a seed fixes the released threshold."""
    policy = tpol.QuantilePolicy(release_sigma=1.0)
    norms = torch.ones(4)
    with pytest.raises(ValueError, match="generator"):
        policy.update(policy.init_state(), norms)
    a, _ = policy.update(policy.init_state(), norms, generator=torch.Generator().manual_seed(5))
    b, _ = policy.update(policy.init_state(), norms, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a["clip_norm"], b["clip_norm"]) and int(a["step"]) == 1


def test_automatic_sensitivity_bounds_contributions():
    """||C_i g_i|| <= sensitivity() == 1 for automatic clipping."""
    _, tm, _, tparams, batch = pair("mlp")
    policy = tpol.AutomaticPolicy(gamma=0.01)
    _, _, aux = run_port(tm, tparams, batch, "mixed_ghost", policy=policy)
    contrib = aux["clip_factors"] * aux["per_sample_norms"]
    assert float(contrib.max()) <= policy.sensitivity(policy.init_state()) + 1e-6


def test_quantile_epsilon_composed_as_the_jax_accountant():
    """The quantile release is composed beside the gradient mechanism, as
    repro.core.accountant composes it; the target-epsilon search lands on
    the JAX engine's noise multiplier."""
    def loss(params, batch, ctx):
        raise NotImplementedError  # accounting only

    kw = dict(loss_with_ctx=loss, batch_size=8, sample_size=10_000, steps=64,
              max_grad_norm=1.0, noise_multiplier=1.3)
    eng = PrivacyEngine(**kw, clip_policy=tpol.make_policy("quantile", release_sigma=0.7),
                        device="cpu")
    eps, delta = eng.privacy_spent(steps=64)
    want = jcompute_epsilon(q=8 / 10_000, sigma=1.3, steps=64, delta=delta,
                            release_sigmas=(0.7,))
    assert eps == pytest.approx(want, abs=1e-12)
    eng.record_step(64)
    assert eng.accountant.get_epsilon(delta) == pytest.approx(eps, abs=1e-9)
    fixed = PrivacyEngine(**kw, device="cpu")
    assert eps > fixed.privacy_spent(steps=64)[0]
    target = dict(kw, noise_multiplier=None, target_epsilon=2.0)
    tq = PrivacyEngine(**target, clip_policy=tpol.QuantilePolicy(release_sigma=0.7),
                       device="cpu")
    jq = JPrivacyEngine(**target, clip_policy=jpol.QuantilePolicy(release_sigma=0.7))
    assert tq.noise_multiplier == pytest.approx(jq.noise_multiplier, rel=1e-12)
    assert tq.noise_multiplier > PrivacyEngine(**target, device="cpu").noise_multiplier


@pytest.mark.parametrize("mode", ["vmap", "bk_mixed_taps"])
def test_privacy_engine_runs_every_mode_with_a_policy(mode):
    """PrivacyEngine takes the new modes and a make_policy policy; its
    policy state starts on the engine's device."""
    _, tm, _, tparams, batch = pair("mlp")
    eng = PrivacyEngine(loss_with_ctx=tm.loss_with_ctx, batch_size=4, sample_size=100,
                        steps=2, max_grad_norm=0.3, noise_multiplier=1.0, mode=mode,
                        clip_policy=tpol.make_policy("per_layer", groups=("emb",),
                                                     clip_norm=0.3), device="cpu")
    pstate = eng.init_policy_state()
    assert pstate["thresholds"].device == CPU
    _, g, aux = eng.clipped_grad_fn()(tparams, interop.batch_from_numpy(batch, device=CPU),
                                      pstate)
    assert aux["clip_factors"].shape == (4,)
    noisy = eng.privatize(g, torch.Generator().manual_seed(0), pstate)
    assert flatten_dict(noisy).keys() == flatten_dict(tparams).keys()
    with pytest.raises(ValueError, match="unknown clipping mode"):
        PrivacyEngine(loss_with_ctx=tm.loss_with_ctx, batch_size=4, sample_size=100,
                      steps=2, max_grad_norm=0.3, noise_multiplier=1.0, mode="opacus",
                      device="cpu")
