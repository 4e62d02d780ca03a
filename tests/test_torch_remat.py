"""``ScannedStack`` rematerialisation in the port, held against itself (remat
off) and against the JAX package (``cfg.remat=True``).

The 2-layer reduced ViT (d_model 64, 4 heads, T = 16) with the same numpy
weights and batch.  Remat changes no value: every clipping mode under every
policy family gives the same loss, per-sample norms and clipped gradient
sum with remat on and off, bit for bit on the CPU (stated tolerance 0).
Against the JAX package under remat: norms rtol 1e-5, clipped sums 5e-5 of
the largest entry, as ``test_torch_vit_step.py`` holds them.  The counts
show what remat does: each layer's forward runs again in every backward
that needs it (the second-backward modes twice), the probes bank once per
(tap, layer) per step, and ``vmap`` runs its stack without remat
(``torch.func`` refuses checkpointing's saved-tensor hooks; documented in
``nn/stack.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_native import VIT_BASE as JVIT_BASE
from repro.core import clipping as jclip
from repro.models import vit as jvit
from repro_torch import interop
from repro_torch.configs.paper_native import VIT_BASE
from repro_torch.core import clipping as tclip
from repro_torch.core import ghost as tghost
from repro_torch.models import vit as tvit
from repro_torch.policies import make_policy
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

IMAGE, PATCH, N_CLASSES, B = 16, 4, 10, 3
CLIP_NORM = 0.3
GROUPED = ["vmap", "mixed_ghost", "bk_mixed", "mixed_ghost_taps", "bk_mixed_taps"]
POLICIES = {
    "automatic": dict(name="automatic", gamma=0.01),
    "quantile": dict(name="quantile", clip_norm=CLIP_NORM, target_quantile=0.5),
    "per_layer": dict(name="per_layer", groups=("layers", "patch_embed"), clip_norm=CLIP_NORM),
}


def _port_model(remat: bool):
    cfg = dataclasses.replace(VIT_BASE.reduced(), n_layers=2, remat=remat)
    return tvit.ViT(cfg, image_size=IMAGE, patch=PATCH, n_classes=N_CLASSES, device="cpu")


def _setup(seed=0):
    """Numpy weights (the JAX init, biases and the position table shifted so
    every leaf has a gradient) and batch, as both packages take them."""
    jcfg = dataclasses.replace(JVIT_BASE.reduced(), n_layers=2, remat=True)
    jmodel = jvit.ViT(jcfg, image_size=IMAGE, patch=PATCH, n_classes=N_CLASSES)
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    flat = flatten_dict(np_params)
    for path, leaf in flat.items():
        if path.endswith("/b") or path.endswith("/e"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    np_params = unflatten_dict(flat)
    batch = {
        "image": rng.standard_normal((B, IMAGE, IMAGE, 3)).astype(np.float32),
        "label": rng.integers(0, N_CLASSES, size=(B,)).astype(np.int32),
        "mask": np.ones((B,), np.float32),
    }
    return jmodel, np_params, batch


def _port_run(remat: bool, mode: str, policy=None, model=None):
    _, np_params, batch = _setup()
    model = model or _port_model(remat)
    params = interop.params_from_jax(np_params, model.conv_weights, device="cpu")
    cfg = tclip.ClipConfig(mode=mode, clip_norm=CLIP_NORM,
                           policy=None if policy is None else make_policy(**policy))
    return tclip.dp_value_and_clipped_grad(model.loss_with_ctx, cfg)(
        params, interop.batch_from_numpy(batch, device="cpu"))


def _assert_equal(got, want):
    (l0, g0, a0), (l1, g1, a1) = got, want
    assert torch.equal(l0, l1)
    assert torch.equal(a0["per_sample_norms"], a1["per_sample_norms"])
    assert torch.equal(a0["clip_factors"], a1["clip_factors"])
    f0, f1 = flatten_dict(g0), flatten_dict(g1)
    assert f0.keys() == f1.keys()
    for k in f0:
        assert torch.equal(f0[k], f1[k]), k


@pytest.mark.parametrize("mode", tclip.MODES)
def test_remat_changes_no_value(mode):
    """Fixed policy, every mode: remat on == remat off, bit for bit."""
    _assert_equal(_port_run(True, mode), _port_run(False, mode))


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("mode", GROUPED)
def test_remat_changes_no_value_under_policies(mode, policy):
    _assert_equal(_port_run(True, mode, POLICIES[policy]),
                  _port_run(False, mode, POLICIES[policy]))


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "vmap", "mixed_ghost_taps",
                                  "bk_mixed_taps", "non_private"])
def test_port_remat_matches_jax_remat(mode):
    jmodel, np_params, batch = _setup()
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    jfn = jclip.dp_value_and_clipped_grad(jmodel.loss_with_ctx,
                                          jclip.ClipConfig(mode=mode, clip_norm=CLIP_NORM))
    jloss, jg, jaux = jfn(jparams, jax.tree_util.tree_map(jax.numpy.asarray, batch))
    model = _port_model(True)
    tloss, tg, taux = _port_run(True, mode, model=model)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(taux["per_sample_norms"].numpy(),
                               np.asarray(jaux["per_sample_norms"]), rtol=1e-5, atol=1e-6)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, model.conv_weights))
    scale = max([1.0] + [float(np.abs(v).max()) for v in jflat.values()])
    for path, want in jflat.items():
        assert float(np.abs(tflat[path] - want).max()) <= 5e-5 * scale, path


class _CountingBlock:
    """Wraps the stack's block and counts its forwards."""

    def __init__(self, block):
        self.block, self.calls = block, 0

    def __getattr__(self, name):
        return getattr(self.block, name)

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.block(*args, **kw)


# forwards of the 2-layer stack per step: the forward, then once per
# backward that needs the saved tensors (vmap: no remat)
FORWARDS = {"mixed_ghost": (2, 6), "bk_mixed": (2, 4), "mixed_ghost_taps": (2, 6),
            "bk_mixed_taps": (2, 4), "non_private": (2, 4), "vmap": (2, 2)}


@pytest.mark.parametrize("mode", sorted(FORWARDS))
def test_remat_recomputes_each_layer_per_backward(mode, monkeypatch):
    """Each backward over the graph runs the layers again (the second pass
    gets its saved tensors again), and the fused probes bank once per (tap,
    layer) in the "bank" phase, however often the layer runs."""
    banked = []
    real = tghost.tap_bank

    def counting(meta, a, g, **kw):
        banked.append(kw["mode"])
        return real(meta, a, g, **kw)

    monkeypatch.setattr(tghost, "tap_bank", counting)
    for remat, want in zip((False, True), FORWARDS[mode]):
        banked.clear()
        model = _port_model(remat)
        model.layers.block = _CountingBlock(model.layers.block)
        _port_run(remat, mode, model=model)
        assert model.layers.block.calls == want, (remat, model.layers.block.calls)
        if mode in ("mixed_ghost", "bk_mixed"):
            meta = tclip.discover_meta(
                model.loss_with_ctx,
                interop.params_from_jax(_setup()[1], model.conv_weights, device="cpu"),
                interop.batch_from_numpy(_setup()[2], device="cpu"))
            keys = sum(m.n_stack for m in meta.values())
            assert len(banked) == keys  # once per (tap, layer) per step


def test_vmap_under_a_remat_model_runs_without_checkpoint():
    """The vmap oracle turns the stacks' remat off for its forward
    (``Ctx.disabled(remat=False)``) and gives remat-off's values."""
    _assert_equal(_port_run(True, "vmap"), _port_run(False, "vmap"))
    ctx = tclip.Ctx.disabled(remat=False)
    assert not ctx.scope("layers").layer(0, 2).remat
    assert tclip.Ctx.disabled().remat


@pytest.mark.parametrize("mode", ["mixed_ghost", "bk_mixed", "mixed_ghost_taps",
                                  "bk_mixed_taps", "ghost_taps"])
def test_grouped_step_frees_its_graph_under_remat(mode):
    """A per_layer step (one partial backward per group on the retained
    graph) on a rematerialised LM leaves nothing alive once it returns: no
    tensor on the parameters' storage survives them.  The explicit engine
    under a checkpointed stack kept its graph, and with it every parameter
    leaf, alive while its pre-activations stayed in the ``Ctx`` that the
    recomputation closes over (0.84 GiB a call at the Yi-6B oracle's size
    on the card)."""
    import gc
    import warnings

    from repro_torch.configs.registry import build_model, get_arch
    from repro_torch.data.synthetic import synthetic_arch_batch
    from repro_torch.policies import PerLayerPolicy

    def step():
        cfg = get_arch("yi-6b").reduced()
        assert cfg.remat
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        batch = synthetic_arch_batch(cfg, batch=2, seq=32, device="cpu")
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
