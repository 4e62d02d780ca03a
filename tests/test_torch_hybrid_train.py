"""DP training of the hybrid LM (Jamba) in the port, held against the JAX
package, and the recurrent archs' taps, parameters and memory.

- (``jamba-1.5-large-398b`` in all ten clipping modes against the JAX
  package is ``tests/test_torch_jamba_modes.py``, on this file's
  ``_pair`` and ``_batch``: a file of its own, so the workers take it
  apart from the rest.)
- Jamba's and xLSTM's taps and shape fingerprints against the JAX
  package's (the late ``wr`` taps, ``dw_conv``, ``bias``, ``scale_grouped``),
  and coverage of every leaf.
- ``interop`` on the full configs' trees at reduced widths: the
  per-position ``SequentialBlocks`` keys and Jamba's bf16 leaves.
- A grouped step on the reduced xLSTM under remat frees its graph in the
  fused and explicit modes (the late taps' pre-activations leave the
  ``Ctx`` that a recomputation closes over).
"""
import dataclasses
import functools
import gc
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.core import clipping as jclip
from repro.tuner.plan import shape_fingerprint as jfingerprint
from repro_torch import interop
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.core import clipping as tclip
from repro_torch.data.synthetic import synthetic_arch_batch
from repro_torch.policies import PerLayerPolicy
from repro_torch.tuner.plan import shape_fingerprint as tfingerprint
from repro_torch.utils.tree import flatten_dict, unflatten_dict

RECURRENT = ["jamba-1.5-large-398b", "xlstm-350m"]
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(JAX model, JAX model without remat, port model, numpy params)."""
    jcfg, tcfg = JARCHS[name].reduced(), get_arch(name).reduced()
    jmodel = jbuild(jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)  # gains off one: every leaf carries signal
    flat = flatten_dict(jparams)
    for path, leaf in flat.items():
        if path.endswith(("/g", "/D")):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return (jmodel, jbuild(dataclasses.replace(jcfg, remat=False)),
            build_model(tcfg, device="cpu"), unflatten_dict(flat))


def _batch(seed: int, vocab: int = 128, b: int = 2, s: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32), "labels": labels,
            "mask": np.ones((b,), np.float32)}


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_taps_and_fingerprint_match_jax(name):
    """Same tap names, kinds, (T, D, p), groups, param paths and stack dims,
    so a plan's fingerprint agrees across the packages; the late taps are
    the sLSTM's recurrent weights, recorded without an activation."""
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
                tm.stack_dims, tm.s_shape, tm.a_shape is None) == (
            jm.kind, jm.T, jm.D, jm.p, jm.n_groups, jm.param_path, jm.bias_path,
            jm.stack_dims, tuple(jm.s_shape), jm.a_shape is None), key
        assert tm.late == (not jm.fused and jm.a_shape is None and jm.kind == "matmul"), key
    assert tfingerprint(tmeta) == jfingerprint(jmeta)
    late = sorted(k for k, m in tmeta.items() if m.late)
    assert late == (["layers/0/b/wr@out"] if name == "xlstm-350m" else [])
    kinds = {m.kind for m in tmeta.values()}
    assert {"dw_conv", "matmul", "embedding", "scale"} <= kinds
    if name.startswith("jamba"):
        assert {"bias", "scale_grouped"} <= kinds
        assert tmeta["layers/1/moe/wg@out"].n_groups == 4  # MoE on every other layer
    assert tclip.validate_coverage(tmeta, np_params) == []


@pytest.mark.parametrize("name", RECURRENT)
def test_interop_carries_the_full_config_trees(name):
    """The per-position ``SequentialBlocks`` keys of the full pattern and
    the config's parameter dtype (Jamba: bf16) cross unchanged, every leaf
    in its JAX shape and value."""
    over = dict(d_model=64, n_heads=4, n_kv=4, d_ff=96 if get_arch(name).d_ff else 0,
                vocab=128, moe_experts=min(get_arch(name).moe_experts, 2), ssm_d_state=8,
                ssm_head_dim=8, ssm_chunk=8, n_layers=len(get_arch(name).block_pattern))
    jcfg = dataclasses.replace(JARCHS[name], **over)
    tcfg = dataclasses.replace(get_arch(name), **over)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(3))
    tmodel = build_model(tcfg, device="cpu")
    got = flatten_dict(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tmodel.conv_weights, device="cpu"))
    own = flatten_dict(tmodel.init(torch.Generator().manual_seed(0)))
    jflat = flatten_dict(jparams)
    assert got.keys() == own.keys() == jflat.keys()
    for path, leaf in got.items():  # the config's dtype; the MoE router stays fp32
        assert leaf.dtype == own[path].dtype, path
        assert str(leaf.dtype).removeprefix("torch.") == jflat[path].dtype.name, path
        assert leaf.shape == own[path].shape == jflat[path].shape, path
        assert np.array_equal(leaf.float().numpy(), np.asarray(jflat[path], np.float32)), path
    assert any(path.startswith("layers/7/") for path in got)  # the period's last block
    bf16 = {p for p, leaf in got.items() if leaf.dtype == torch.bfloat16}
    assert bool(bf16) == (tcfg.param_dtype == "bfloat16")
    back = flatten_dict(interop.grads_to_jax_layout(unflatten_dict(got), ()))
    assert all(np.array_equal(back[p].astype(np.float32), np.asarray(jflat[p], np.float32))
               for p in jflat)


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "mixed_ghost_taps",
                                  "bk_mixed_taps", "ghost_taps"])
def test_grouped_step_frees_its_graph_under_remat(mode):
    """A per_layer step on the rematerialised reduced xLSTM leaves nothing on
    the parameters' storage alive once it returns: the late ``wr`` taps'
    pre-activations leave the ``Ctx`` after the first backward (a
    checkpointed layer's recomputation closes over it), and a
    recomputation's late records never replace the first forward's."""
    def step():
        cfg = get_arch("xlstm-350m").reduced()
        assert cfg.remat
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        batch = synthetic_arch_batch(cfg, batch=2, seq=16, device="cpu")
        policy = PerLayerPolicy(groups=("layers", "embed"), clip_norm=1.0)
        tclip.dp_value_and_clipped_grad(
            model.loss_with_ctx, tclip.ClipConfig(mode=mode, policy=policy))(params, batch)
        return {v.data_ptr() for v in flatten_dict(params).values()}

    storage = step()
    gc.collect()
    with warnings.catch_warnings():  # the scan touches deprecated module objects
        warnings.simplefilter("ignore", FutureWarning)
        alive = [o for o in gc.get_objects()
                 if isinstance(o, torch.Tensor) and o.data_ptr() in storage]
    assert not alive, [tuple(t.shape) for t in alive]
