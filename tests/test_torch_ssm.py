"""The port's SSM pieces, held against the JAX package on the CPU.

- ``nn/ssm_scan``: ``chunked_ssm`` against the JAX ``chunked_ssm`` and
  against both packages' sequential ``ssm_reference`` (T off the chunk, a
  carried ``state0``), ``ssm_decode_step`` chained over T, a strong decay
  whose within-chunk exponents would overflow above the diagonal (the
  port's gradient stays finite and equals the reference's), and
  ``torch.func.vmap`` over the batch (the vmap oracle runs the scan);
- ``nn/conv.DepthwiseConv1d`` with and without a carried state;
- ``nn/xlstm.SLSTMScan`` (the sLSTM time loop as one autograd node with
  its backward written out) against the loop recorded op by op: outputs
  bit for bit, gradients of the input stream, the carry and ``wr`` in fp32
  (a tie in the stabiliser's maximum included) and in bf16;
- the Mamba, mLSTM and sLSTM blocks' per-tap per-sample norms in every
  clipping mode against the JAX package (the counterpart of
  ``tests/test_clipping_exactness.py::test_ssm_blocks_exactness``): every
  kind the blocks tap (matmul, the late ``wr``, ``dw_conv``, ``bias``,
  ``scale``, ``scale_grouped``, embedding);
- (the reduced ``xlstm-350m`` in all ten clipping modes against the JAX
  package is ``tests/test_torch_xlstm_modes.py``: a file of its own, so
  the workers take it apart from the rest.)

All fp32: the same math summed in another order; 1e-5 relative to the
largest reference entry.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import clipping as jclip
from repro.core.taps import Ctx as JCtx
from repro.nn import conv as jconv
from repro.nn import ssm_scan as jscan
from repro.nn.mamba import MambaBlock as JMamba
from repro.nn.module import Dense as JDense
from repro.nn.module import Embedding as JEmbedding
from repro.nn.xlstm import MLSTMBlock as JMLSTM
from repro.nn.xlstm import SLSTMBlock as JSLSTM
from repro.policies import PerLayerPolicy as JPerLayer
from repro_torch import interop
from repro_torch.core import clipping as tclip
from repro_torch.core.taps import Ctx
from repro_torch.nn import ssm_scan as tscan
from repro_torch.nn.conv import DepthwiseConv1d
from repro_torch.nn.mamba import MambaBlock
from repro_torch.nn.module import Dense, Embedding
from repro_torch.nn.xlstm import MLSTMBlock, SLSTMBlock, SLSTMScan, slstm_scan
from repro_torch.policies import PerLayerPolicy
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

TOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ssm_inputs(b, t, h, dk, dv, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    la = (-decay * np.logaddexp(0.0, rng.standard_normal((b, t, h)))).astype(np.float32)
    return q, k, v, la


# (B, T, H, dk, dv, chunk, with state0): T = 1, T off the chunk, T < chunk,
# several chunks
SSM_CASES = [(1, 1, 1, 2, 2, 4, False), (2, 13, 3, 4, 2, 4, True), (2, 40, 2, 8, 4, 16, False),
             (1, 5, 2, 4, 4, 8, True), (2, 32, 3, 4, 5, 8, True)]


@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_chunked_ssm_matches_jax_and_the_reference(case):
    b, t, h, dk, dv, chunk, with_state = case
    q, k, v, la = _ssm_inputs(b, t, h, dk, dv, seed=t)
    s0 = (np.random.default_rng(1).standard_normal((b, h, dk, dv)).astype(np.float32)
          if with_state else None)
    tin = [torch.as_tensor(x) for x in (q, k, v, la)]
    ts0 = None if s0 is None else torch.as_tensor(s0)
    y, s = tscan.chunked_ssm(*tin, chunk=chunk, state0=ts0)
    assert y.shape == (b, t, h, dv) and s.shape == (b, h, dk, dv) and s.dtype == torch.float32
    jy, js = jscan.chunked_ssm(*(jnp.asarray(x) for x in (q, k, v, la)), chunk=chunk,
                               state0=None if s0 is None else jnp.asarray(s0))
    ry, rs = tscan.ssm_reference(*tin, state0=ts0)
    jry, jrs = jscan.ssm_reference(*(jnp.asarray(x) for x in (q, k, v, la)),
                                   state0=None if s0 is None else jnp.asarray(s0))
    for got, want in ((y, jy), (s, js), (y, ry), (s, rs), (ry, jry), (rs, jrs)):
        assert _rel(got, want) < TOL
    # the serving form, one token at a time from the same state
    state = torch.zeros((b, h, dk, dv)) if ts0 is None else ts0
    ys = []
    for i in range(t):
        yi, state = tscan.ssm_decode_step(*(x[:, i:i + 1] for x in tin), state)
        ys.append(yi)
    assert _rel(torch.cat(ys, dim=1), y) < TOL and _rel(state, s) < TOL


def test_chunked_ssm_strong_decay_keeps_its_gradient_finite():
    """Decay logs summing to ~-300 over a chunk: exp(cum_t - cum_s) above
    the diagonal would overflow.  The port takes exponents of non-positive
    sums only, so its gradient is finite and equals the sequential
    reference's (which never forms the product)."""
    q, k, v, la = _ssm_inputs(2, 24, 2, 4, 3, seed=5, decay=20.0)
    grads = []
    for fn in (lambda *x: tscan.chunked_ssm(*x, chunk=16), tscan.ssm_reference):
        xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v, la)]
        y, s = fn(*xs)
        (y.square().sum() + s.sum()).backward()
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) < 1e-4


def test_chunked_ssm_runs_under_vmap():
    """The vmap oracle maps the scan over samples: each sample's result is
    the batched call's row."""
    q, k, v, la = (torch.as_tensor(x) for x in _ssm_inputs(3, 11, 2, 4, 3, seed=2))
    y, s = torch.func.vmap(lambda *x: tscan.chunked_ssm(*(e[None] for e in x), chunk=4))(
        q, k, v, la)
    yb, sb = tscan.chunked_ssm(q, k, v, la, chunk=4)
    assert _rel(y[:, 0], yb) < TOL and _rel(s[:, 0], sb) < TOL


@pytest.mark.parametrize("t,with_state", [(9, False), (9, True), (1, True), (2, True)])
def test_depthwise_conv1d_matches_jax(t, with_state):
    b, d, k = 2, 6, 4
    rng = np.random.default_rng(t)
    jmod = jconv.DepthwiseConv1d("c", d, k)
    jp = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    jp["b"] = rng.standard_normal(d).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    st = rng.standard_normal((b, k - 1, d)).astype(np.float32) if with_state else None
    js, jstate = jmod(jp, jnp.asarray(x), JCtx.disabled(),
                      state=None if st is None else jnp.asarray(st))
    tmod = DepthwiseConv1d("c", d, k, device=torch.device("cpu"))
    tp = interop.params_from_jax(jp, (), device="cpu")
    ts, tstate = tmod(tp, torch.as_tensor(x), Ctx.disabled(),
                      state=None if st is None else torch.as_tensor(st))
    assert _rel(ts, js) < TOL
    if jstate is not None:  # JAX gives no state for T < k - 1 without one
        assert torch.equal(tstate, torch.as_tensor(np.array(jstate)))
    assert tstate.shape == (b, k - 1, d)


@pytest.mark.parametrize("dtype,tie", [("float32", False), ("float32", True),
                                       ("bfloat16", False)])
def test_slstm_scan_node_matches_the_recorded_loop(dtype, tie):
    b, t, d = 3, 17, 8
    gen = torch.Generator().manual_seed(7)
    dt = getattr(torch, dtype)
    pre = (2 * torch.randn(b, t, 4 * d, generator=gen)).to(dt)
    wr = (torch.randn(d, 4 * d, generator=gen) / d**0.5).to(dt)
    carry = [torch.randn(b, d, generator=gen).to(dt), torch.randn(b, d, generator=gen),
             torch.rand(b, d, generator=gen) + 0.5, torch.randn(b, d, generator=gen)]
    if tie:  # h0 = 0 and m0 = 0: the first step's max(log_f + m, i) ties
        carry[0], carry[3] = torch.zeros(b, d), torch.zeros(b, d)
        pre[:, 0, 2 * d:3 * d] = torch.nn.functional.logsigmoid(pre[:, 0, d:2 * d])
    g_out = [torch.randn(b, t, d, generator=gen).to(dt), torch.randn(b, d, generator=gen).to(dt),
             torch.randn(b, d, generator=gen), torch.randn(b, d, generator=gen),
             torch.randn(b, d, generator=gen)]
    res = []
    for fn in (SLSTMScan.apply, slstm_scan):
        xs = [x.clone().requires_grad_(True) for x in (pre, *carry, wr)]
        outs = fn(*xs)
        grads = torch.autograd.grad(outs, xs, g_out)
        res.append((outs, grads))
    (outs, grads), (want_outs, want_grads) = res
    for got, want in zip(outs, want_outs):
        assert torch.equal(got, want)
    if tie:
        assert bool((F.logsigmoid(pre[:, 0, d:2 * d]) + 0 == pre[:, 0, 2 * d:3 * d]).all())
    tol = TOL if dtype == "float32" else 2e-2
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        assert got.dtype == want.dtype
        assert _rel(got.float(), want.float()) < tol, (i, _rel(got.float(), want.float()))


# -- the blocks' per-tap norms (test_ssm_blocks_exactness's counterpart) -------
D_MODEL, VOCAB = 8, 11


def _jax_blocks_loss():
    mamba = JMamba("m", D_MODEL, expand=2, head_dim=4, d_state=4, chunk=4)
    mls = JMLSTM("ml", D_MODEL, n_heads=2, chunk=4)
    sls = JSLSTM("sl", D_MODEL, n_heads=2)
    emb, head = JEmbedding("emb", VOCAB, D_MODEL), JDense("head", D_MODEL, VOCAB, use_bias=False)
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    params = {"emb": emb.init(ks[0]), "mamba": mamba.init(ks[1]), "mlstm": mls.init(ks[2]),
              "slstm": sls.init(ks[3]), "head": head.init(ks[4])}

    def loss(params, batch, ctx):
        x = emb(params["emb"], batch["tokens"], ctx.scope("emb"))
        h, _ = mamba(params["mamba"], x, ctx.scope("mamba"))
        x, _ = mls(params["mlstm"], x + h, ctx.scope("mlstm"))
        x, _ = sls(params["slstm"], x, ctx.scope("slstm"))
        logp = jax.nn.log_softmax(head(params["head"], x, ctx.scope("head")), axis=-1)
        return -jnp.take_along_axis(logp, batch["labels"][..., None], -1)[..., 0].mean(-1)

    return loss, jax.tree_util.tree_map(np.asarray, params)


def _port_blocks_loss():
    dev = torch.device("cpu")
    mamba = MambaBlock("m", D_MODEL, expand=2, head_dim=4, d_state=4, chunk=4, device=dev)
    mls = MLSTMBlock("ml", D_MODEL, n_heads=2, chunk=4, device=dev)
    sls = SLSTMBlock("sl", D_MODEL, n_heads=2, device=dev)
    emb = Embedding("emb", VOCAB, D_MODEL, device=dev)
    head = Dense("head", D_MODEL, VOCAB, use_bias=False, device=dev)

    def loss(params, batch, ctx):
        x = emb(params["emb"], batch["tokens"], ctx.scope("emb"))
        h = mamba(params["mamba"], x, ctx.scope("mamba"))
        x = mls(params["mlstm"], x + h, ctx.scope("mlstm"))
        x = sls(params["slstm"], x, ctx.scope("slstm"))
        logp = torch.log_softmax(head(params["head"], x, ctx.scope("head")), dim=-1)
        return -torch.take_along_dim(logp, batch["labels"][..., None].long(), -1)[..., 0].mean(-1)

    return loss


@functools.lru_cache(maxsize=None)
def _blocks_setup():
    jloss, jparams = _jax_blocks_loss()
    rng = np.random.default_rng(4)
    flat = flatten_dict(jparams)
    for path in flat:  # gains and the D skip off one: every leaf carries signal
        if path.endswith(("/g", "/D")):
            flat[path] = (flat[path] + 0.1 * rng.standard_normal(flat[path].shape)).astype(
                np.float32)
    jparams = unflatten_dict(flat)
    batch = {"tokens": rng.integers(0, VOCAB, (3, 7)).astype(np.int32),
             "labels": rng.integers(0, VOCAB, (3, 7)).astype(np.int32)}
    return jloss, _port_blocks_loss(), jparams, batch


def test_ssm_blocks_cover_every_leaf_with_every_kind():
    jloss, tloss, jparams, batch = _blocks_setup()
    tparams = interop.params_from_jax(jparams, (), device="cpu")
    tbatch = interop.batch_from_numpy(batch, device="cpu")
    tmeta = tclip.discover_meta(tloss, tparams, tbatch)
    jmeta = jclip.discover_meta(jloss, jparams, batch)
    assert tmeta.keys() == jmeta.keys()
    for key, jm in jmeta.items():
        tm = tmeta[key]
        assert (tm.kind, tm.T, tm.D, tm.p, tm.param_path, tm.bias_path, tm.s_shape) == (
            jm.kind, jm.T, jm.D, jm.p, jm.param_path, jm.bias_path, tuple(jm.s_shape)), key
    assert {m.kind for m in tmeta.values()} == {
        "matmul", "embedding", "scale", "bias", "dw_conv", "scale_grouped"}
    assert tmeta["slstm/wr@out"].late and tmeta["slstm/wr@out"].a_shape is None
    assert tclip.validate_coverage(tmeta, tparams) == []


@pytest.mark.parametrize("mode", [m for m in tclip.MODES if m != "non_private"])
def test_ssm_blocks_per_tap_norms_match_jax(mode):
    """Each tap's per-sample squared norms (``path_norms2``, by weight path)
    in ``mode`` against the JAX package's in the same mode, and the clipped
    step against it."""
    jloss, tloss, jparams, batch = _blocks_setup()
    groups = ("mamba", "mlstm", "slstm")
    jex = jclip.dp_value_and_clipped_grad(
        jloss, jclip.ClipConfig(mode=mode, policy=JPerLayer(groups=groups, clip_norm=0.5)))
    tex = tclip.dp_value_and_clipped_grad(
        tloss, tclip.ClipConfig(mode=mode, policy=PerLayerPolicy(groups=groups, clip_norm=0.5)))
    tparams = interop.params_from_jax(jparams, (), device="cpu")
    tbatch = interop.batch_from_numpy(batch, device="cpu")
    jparams_j = jax.tree_util.tree_map(jnp.asarray, jparams)
    jnorms = jax.jit(lambda p, b: jex._norm_state(p, b).path_norms2)(jparams_j, batch)
    tnorms = tex._norm_state(tparams, tbatch).path_norms2
    assert tnorms.keys() == jnorms.keys()
    for path, want in jnorms.items():
        assert _rel(tnorms[path], want) < TOL, path
    (jl, jg, jaux), (tl, tg, taux) = jax.jit(jex)(jparams_j, batch), tex(tparams, tbatch)
    assert _rel(tl, jl) < TOL
    assert _rel(taux["per_sample_norms"], jaux["per_sample_norms"]) < TOL
    jflat, tflat = flatten_dict(jg), flatten_dict(tg)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jflat.values())
    for path, want in jflat.items():
        assert float(np.abs(tflat[path].numpy() - np.asarray(want)).max()) <= TOL * scale, path
