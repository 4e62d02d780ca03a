"""The reduced ``xlstm-350m`` (one period of 8 layers: sLSTM then 7 mLSTMs,
d_model 64, chunk 8) in all ten clipping modes against the JAX package:
the loss, the per-sample norms and the clipped sums within 1e-5, fp32, the
same numpy parameters and batch (``interop``).  The JAX package's
``*_taps`` reference runs with ``remat=False``, as in
``tests/test_torch_lm_train.py``.

Moved unchanged out of ``tests/test_torch_ssm.py``: at 20-36 s a mode it
is the slowest case there, and a file of its own lets the test workers
(one file each) run it beside the rest.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core import clipping as jclip
from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core import clipping as tclip
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from test_torch_ssm import TOL, _rel
from torch_threads import torch_threads_per_worker  # noqa: F401


# -- the reduced xLSTM, all ten modes --------------------------------------------
@functools.lru_cache(maxsize=None)
def _xlstm():
    jcfg, tcfg = JARCHS["xlstm-350m"].reduced(), get_arch("xlstm-350m").reduced()
    jmodel = jbuild(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = flatten_dict(jparams)
    for path, leaf in flat.items():
        if path.endswith("/g"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return (jmodel, jbuild(dataclasses.replace(jcfg, remat=False)),
            build_model(tcfg, device="cpu"), unflatten_dict(flat))


def _lm_batch(seed: int, vocab: int = 128, b: int = 2, s: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32), "labels": labels,
            "mask": np.ones((b,), np.float32)}


@pytest.mark.parametrize("mode", tclip.MODES)
def test_xlstm_clipped_step_matches_jax(mode):
    jmodel, jmodel_noremat, tmodel, np_params = _xlstm()
    batch = _lm_batch(1)
    jm = jmodel_noremat if mode.endswith("_taps") else jmodel
    cfg = dict(mode=mode, clip_norm=0.3)
    jl, jg, jaux = jax.jit(jclip.dp_value_and_clipped_grad(
        jm.loss_with_ctx, jclip.ClipConfig(**cfg)))(
        jax.tree_util.tree_map(jnp.asarray, np_params), batch)
    tparams = interop.params_from_jax(np_params, tmodel.conv_weights, device="cpu")
    tl, tg, taux = tclip.dp_value_and_clipped_grad(tmodel.loss_with_ctx,
                                                   tclip.ClipConfig(**cfg))(
        tparams, interop.batch_from_numpy(batch, device="cpu"))
    assert _rel(tl, jl) < TOL
    if mode != "non_private":
        assert _rel(taux["per_sample_norms"], jaux["per_sample_norms"]) < TOL
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, ()))
    assert tflat.keys() == jflat.keys()
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    err = max(float(np.abs(tflat[p] - w).max()) for p, w in jflat.items())
    assert err <= TOL * scale, err / scale
