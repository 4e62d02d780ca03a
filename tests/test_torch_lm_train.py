"""DP training of the decoder LMs in the port, held against the JAX package.

Each of the six dense and MoE archs (``yi-6b``, ``codeqwen1.5-7b``,
``qwen1.5-32b``, ``qwen2-72b``, ``mixtral-8x7b``, ``arctic-480b``) at its
``.reduced()`` size (d_model 64, vocab 128, 2-4 layers, 4 experts for the
MoE archs, attention blocks of 16) with the same numpy parameters
(``repro_torch.interop``) and the same numpy batch (2 samples of 32 tokens,
some labels -100) in both packages on the CPU.  Compared in all ten
clipping modes: the mean loss and the per-sample norms (1e-5 relative, the
norms against the largest), and the clipped gradient sums (1e-5 of the
largest reference entry); fp32 throughout: the same math summed in another
order.  Both run their configs' remat, except that the JAX package's
explicit-tap engine (``*_taps``) cannot trace its own checkpointed
``head_loss`` (an UnexpectedTracerError), so its reference for those four
modes runs with ``remat=False``, which computes the same function.

One bf16 case (reduced Yi-6B, bf16 compute, fp32 parameters): the loss and
the norms against the JAX bf16 step at 1e-2 relative (the frameworks round
to bf16 at other places, each rounding up to 2^-9, compounded over four
blocks), the clipped sums against the JAX fp32 step at 4e-2 of the largest
entry.  The embedding table's gradient sets that bound: it sums the bf16
cotangents of repeated ids, and the JAX package's own bf16 step lands
3.3e-2 from its fp32 step there (every other leaf within 4e-3).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core import clipping as jclip
from repro.models.losses import per_sample_xent as jxent
from repro.tuner.plan import shape_fingerprint as jfingerprint
from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core import clipping as tclip
from repro_torch.models.losses import per_sample_xent as txent
from repro_torch.tuner.plan import shape_fingerprint as tfingerprint
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

ARCHS = ["yi-6b", "codeqwen1.5-7b", "qwen1.5-32b", "qwen2-72b", "mixtral-8x7b",
         "arctic-480b"]
CLIP_NORM = 0.3
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(name: str, dtype: str = "float32"):
    """(JAX model, JAX model without remat, port model, numpy params)."""
    jcfg = dataclasses.replace(JARCHS[name].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(name).reduced(), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    # norm gains of one give tiny gain gradients: spread them so every leaf
    # carries signal
    rng = np.random.default_rng(0)
    flat = flatten_dict(jparams)
    for path, leaf in flat.items():
        if path.endswith("/g"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    np_params = unflatten_dict(flat)
    return (jmodel, jbuild(dataclasses.replace(jcfg, remat=False)),
            build_model(tcfg, device="cpu"), np_params)


def _batch(seed: int, vocab: int = 128, b: int = 2, s: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32), "labels": labels,
            "mask": np.ones((b,), np.float32)}


def _run_both(name, mode, dtype="float32", batch=None):
    jmodel, jmodel_noremat, tmodel, np_params = _pair(name, dtype)
    batch = _batch(1) if batch is None else batch
    jm = jmodel_noremat if mode.endswith("_taps") else jmodel
    cfg = dict(mode=mode, clip_norm=CLIP_NORM)
    jres = jax.jit(jclip.dp_value_and_clipped_grad(jm.loss_with_ctx, jclip.ClipConfig(**cfg)))(
        jax.tree_util.tree_map(jax.numpy.asarray, np_params), batch)
    tparams = interop.params_from_jax(np_params, tmodel.conv_weights, device="cpu")
    tres = tclip.dp_value_and_clipped_grad(tmodel.loss_with_ctx, tclip.ClipConfig(**cfg))(
        tparams, interop.batch_from_numpy(batch, device="cpu"))
    return jres, tres


def _grad_err(tg, jg) -> float:
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, ()))
    assert tflat.keys() == jflat.keys()
    scale = max(float(np.abs(v.astype(np.float32)).max()) for v in jflat.values())
    return max(float(np.abs(tflat[p].astype(np.float32) - w.astype(np.float32)).max())
               for p, w in jflat.items()) / scale


@pytest.mark.parametrize("mode", tclip.MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_lm_clipped_step_matches_jax(name, mode):
    (jloss, jg, jaux), (tloss, tg, taux) = _run_both(name, mode)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    jn = np.asarray(jaux["per_sample_norms"])
    tn = taux["per_sample_norms"].numpy()
    assert tn.shape == jn.shape == (2,)
    if mode != "non_private":  # C_i = 1 there: no norms
        assert float(np.abs(tn - jn).max()) <= TOL * float(np.abs(jn).max()), (tn, jn)
    assert _grad_err(tg, jg) <= TOL


@pytest.mark.parametrize("name", ARCHS)
def test_lm_taps_and_fingerprint_match_jax(name):
    """Same tap names, kinds, (T, D, p), groups, param paths and stack dims,
    so a plan's fingerprint agrees across the packages."""
    jmodel, _, tmodel, np_params = _pair(name)
    batch = _batch(2)
    jmeta = jclip.discover_meta(jmodel.loss_with_ctx, np_params, batch)
    tmeta = tclip.discover_meta(
        tmodel.loss_with_ctx, interop.params_from_jax(np_params, (), device="cpu"),
        interop.batch_from_numpy(batch, device="cpu"))
    assert tmeta.keys() == jmeta.keys()
    for key, jm in jmeta.items():
        tm = tmeta[key]
        assert (tm.kind, tm.T, tm.D, tm.p, tm.n_groups, tm.param_path, tm.bias_path,
                tm.stack_dims, tm.s_shape) == (
            jm.kind, jm.T, jm.D, jm.p, jm.n_groups, jm.param_path, jm.bias_path,
            jm.stack_dims, tuple(jm.s_shape)), key
    assert tfingerprint(tmeta) == jfingerprint(jmeta)
    if get_arch(name).moe_experts:
        assert tmeta["layers/moe/wg@out"].n_groups == 4
    assert tclip.validate_coverage(tmeta, np_params) == []


@pytest.mark.parametrize("mode", ["non_private", "mixed_ghost", "bk_mixed"])
def test_lm_bf16_step_matches_jax(mode):
    (jloss, _, jaux), (tloss, tg, taux) = _run_both("yi-6b", mode, "bfloat16")
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)
    np.testing.assert_allclose(taux["per_sample_norms"].numpy(),
                               np.asarray(jaux["per_sample_norms"]), rtol=1e-2)
    (_, jg32, _), _ = _run_both("yi-6b", mode)
    for leaf in flatten_dict(tg).values():
        assert leaf.dtype == torch.float32
    assert _grad_err(tg, jg32) <= 4e-2


@pytest.mark.parametrize("masked", [False, True])
def test_per_sample_xent_matches_jax(masked):
    """Ignored labels (-100) and a sample mask."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 9, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 9)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, :] = -100  # every label ignored: the loss is 0, not NaN
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    want = np.asarray(jxent(logits, labels, mask))
    got = txent(torch.as_tensor(logits), torch.as_tensor(labels),
                None if mask is None else torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[2] == 0.0
