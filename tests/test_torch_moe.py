"""The port's MoE routing (``repro_torch/nn/moe.py``) against the JAX
package's ``_dispatch_one`` / ``_combine_one`` and ``MoE``.

The same numpy inputs go through both packages on the CPU.  Compared: the
slot tables (token per (expert, slot), the empty sentinel included), the
chosen experts, slots, gates and kept flags, exactly (integer tables; the
gates to 1e-6), per sample and in the global (serving) dispatch, at the
configured capacity and at one small enough to drop tokens; the combine and
the whole layer's output to 1e-5 relative in fp32.  Reduced Mixtral's
prefill and decode logits are held to the JAX ``DecoderLM``'s to 1e-5 of
the largest logit: the prefill dispatches globally in both; the port's
batched decode dispatches per lane, as the JAX engine's ``vmap`` of a B=1
decode does, which at 2 lanes equals the JAX B=2 decode (no expert can
overflow) and at 4 lanes equals the JAX B=1 decodes lane by lane.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core.taps import Ctx as JCtx
from repro.nn import moe as jmoe
from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core.taps import Ctx
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.nn import moe as tmoe
from torch_threads import torch_threads_per_worker  # noqa: F401

E, K, D, F = 4, 2, 8, 12


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _jax_tables(x, logits, cap):
    """The JAX package's per-sample dispatch, vmapped as its MoE does."""
    xe, (idx, slot, gates, keep) = jax.vmap(
        lambda xx, ll: jmoe._dispatch_one(xx, ll, K, cap, E))(x, logits)
    return xe, idx, slot, gates, keep


@pytest.mark.parametrize("cap", [3, 6, 20])  # 3 and 6 drop tokens (T*K/E = 6)
@pytest.mark.parametrize("b,t", [(2, 12), (1, 24)])
def test_dispatch_and_combine_match_jax(b, t, cap):
    rng = np.random.default_rng(cap + t)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    logits = rng.standard_normal((b, t, E)).astype(np.float32)
    jxe, jidx, jslot, jgates, jkeep = _jax_tables(x, logits, cap)
    table, idx, slot, gates, keep = tmoe.dispatch_tables(torch.as_tensor(logits), K, cap)
    xe = tmoe.dispatch_tokens(torch.as_tensor(x), table)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), atol=1e-6)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jxe))  # gathers: exact
    if cap == 3:  # below the mean load T*K/E: some entries must be dropped
        assert int((~keep).sum()) > 0
    # every kept entry sits in its table cell; empty cells hold the sentinel
    kept_cells = {(int(b_), int(e), int(s)) for b_, e, s in zip(
        *[v[keep] for v in (torch.arange(b)[:, None, None].expand_as(idx), idx, slot)])}
    assert int((table != t).sum()) == len(kept_cells) == int(keep.sum())
    ye = rng.standard_normal((b, E, cap, D)).astype(np.float32)
    jy = jax.vmap(lambda yy, ii: jmoe._combine_one(yy, ii, K, cap))(
        ye, (jidx, jslot, jgates, jkeep))
    ty = tmoe.combine(torch.as_tensor(ye), idx, slot, gates, keep)
    assert _rel(ty, jy) < 1e-5


def _layers(cap_factor):
    jm = jmoe.MoE("moe", D, F, E, K, capacity_factor=cap_factor)
    tm = tmoe.MoE("moe", D, F, E, K, capacity_factor=cap_factor, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, params, interop.params_from_jax(params, (), device="cpu")


@pytest.mark.parametrize("dispatch", ["per_sample", "global"])
@pytest.mark.parametrize("cap_factor", [1.25, 0.5])  # 0.5 drops tokens
def test_moe_layer_matches_jax(dispatch, cap_factor):
    jm, tm, jp, tp = _layers(cap_factor)
    x = np.random.default_rng(3).standard_normal((3, 10, D)).astype(np.float32)
    assert tm.capacity(10) == jm.capacity(10) and tm.capacity(30) == jm.capacity(30)
    jy = jm(jp, jnp.asarray(x), JCtx.disabled(), dispatch=dispatch)
    ty = tm(tp, torch.as_tensor(x), Ctx.disabled(), dispatch=dispatch)
    assert ty.shape == (3, 10, D)
    assert _rel(ty, jy) < 1e-5


def test_moe_taps_match_jax():
    """The three expert taps: grouped matmuls with n_groups = E, T = C, and
    the fp32 router tap."""
    jm, tm, jp, tp = _layers(1.25)
    x = np.random.default_rng(4).standard_normal((2, 10, D)).astype(np.float32)
    jmeta, tmeta = {}, {}
    jm(jp, jnp.asarray(x), JCtx(meta=jmeta))
    tm(tp, torch.as_tensor(x), Ctx(meta=tmeta))
    assert tmeta.keys() == jmeta.keys() == {"router/out", "wg@out", "wu@out", "wo@out"}
    for name, j in jmeta.items():
        t = tmeta[name]
        assert (t.kind, t.T, t.D, t.p, t.n_groups, t.param_path, t.s_shape) == (
            j.kind, j.T, j.D, j.p, j.n_groups, j.param_path, tuple(j.s_shape)), name
    assert tmeta["wg@out"].n_groups == E and tmeta["wg@out"].T == tm.capacity(10)


def test_unknown_dispatch_raises():
    _, tm, _, tp = _layers(1.25)
    with pytest.raises(ValueError, match="dispatch"):
        tm(tp, torch.zeros(1, 4, D), Ctx.disabled(), dispatch="token")


def test_reduced_mixtral_prefill_and_decode_match_jax():
    jcfg, tcfg = JARCHS["mixtral-8x7b"].reduced(), get_arch("mixtral-8x7b").reduced()
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tp = interop.params_from_jax(jp, tmodel.conv_weights, device="cpu")
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    jlog, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens)}, jmodel.init_state(2, 16))
    prefill = make_prefill_step(tmodel)
    with torch.no_grad():
        tlog, tstate = prefill(tp, {"tokens": torch.as_tensor(tokens)},
                               tmodel.init_state(2, 16))
        assert _rel(tlog, jlog) < 1e-5
        decode = make_decode_step(tmodel)
        for _ in range(3):
            nxt = np.argmax(np.asarray(jlog)[:, -1:], axis=-1)
            jlog, jstate = jmodel.decode_step(jp, jnp.asarray(nxt, jnp.int32), jstate)
            tnext, tlog, tstate = decode(tp, torch.as_tensor(nxt), tstate)
            assert _rel(tlog, jlog) < 1e-5
            np.testing.assert_array_equal(tnext.numpy(), np.argmax(np.asarray(jlog), -1))


def test_batched_decode_dispatches_per_lane():
    """4 lanes at one token each: each lane routes within its own capacity,
    so the batched decode equals four JAX B=1 decodes (the JAX engine's
    vmapped step), whatever the global capacity would have dropped."""
    jcfg, tcfg = JARCHS["mixtral-8x7b"].reduced(), get_arch("mixtral-8x7b").reduced()
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    tp = interop.params_from_jax(jp, tmodel.conv_weights, device="cpu")
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab, (4, 7)).astype(np.int32)
    nxt = np.random.default_rng(7).integers(0, tcfg.vocab, (4, 1)).astype(np.int32)
    _, js = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens)}, jmodel.init_state(4, 16))

    def lane_state(lane):  # k/v leaves are (L, B, ...); pos and idx carry no batch
        cache = jax.tree_util.tree_map_with_path(
            lambda path, x: x[:, lane:lane + 1] if path[-1].key in ("k", "v") else x,
            js["cache"])
        return {"cache": cache, "pos": js["pos"]}

    want = [np.asarray(jmodel.decode_step(jp, jnp.asarray(nxt[lane:lane + 1]),
                                          lane_state(lane))[0]) for lane in range(4)]
    with torch.no_grad():
        _, ts = tmodel.prefill(tp, {"tokens": torch.as_tensor(tokens)}, tmodel.init_state(4, 16))
        tl, _ = tmodel.decode_step(tp, torch.as_tensor(nxt), ts)
    assert _rel(tl, np.concatenate(want)) < 1e-5
