"""Weights between the packages' layouts: conv weights as the model names them.

Only the weights of the model's ``Conv2d`` modules change layout (HWIO <->
OIHW), whatever they are called; a 4-D leaf elsewhere, such as a stacked MoE
expert weight (L, E, D, F), crosses unchanged both ways.  The reduced
Mixtral and Arctic trees (router, experts (L, E, d, f) / (L, E, f, d),
Arctic's dense-residual MLP) cross leaf by leaf, and the port's own tree
has the JAX tree's paths, shapes and dtypes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_native import VIT_BASE as JVIT_BASE
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import build_model as jbuild
from repro.models import cnn, vit
from repro_torch import interop
from repro_torch.configs.paper_native import VIT_BASE
from repro_torch.configs.registry import build_model, get_arch
from repro_torch.models import cnn as tcnn
from repro_torch.models import vit as tvit
from repro_torch.utils.tree import flatten_dict


TINY_VGG = (8, "M", 16, "M")  # the VGG's conv<i> naming at a few channels


@pytest.mark.parametrize("build", [
    lambda: (cnn.VGG("vgg_tiny", groups=4), tcnn.VGG("vgg_tiny", groups=4, device="cpu")),
    lambda: (cnn.ResNet((1, 1), width=8), tcnn.ResNet((1, 1), width=8, device="cpu")),
    lambda: (vit.ViT(JVIT_BASE.reduced(), image_size=16, patch=4, n_classes=10),
             tvit.ViT(VIT_BASE.reduced(), image_size=16, patch=4, n_classes=10, device="cpu")),
], ids=["vgg", "resnet", "vit"])
def test_conv_weights_cross_as_oihw(build, monkeypatch):
    monkeypatch.setitem(cnn.VGG_PLANS, "vgg_tiny", TINY_VGG)
    monkeypatch.setitem(tcnn.VGG_PLANS, "vgg_tiny", TINY_VGG)
    jmodel, tmodel = build()
    # the JAX tree's paths and shapes (traced, not computed), random values
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    flat = flatten_dict(tree)
    # the model names exactly its conv layers, which are these models' 4-D leaves
    convs = tmodel.conv_weights
    assert convs and sorted(convs) == sorted(p for p, leaf in flat.items() if leaf.ndim == 4)
    port = flatten_dict(interop.params_from_jax(tree, convs, device="cpu"))
    own = flatten_dict(tmodel.init(torch.Generator().manual_seed(0)))
    for path, leaf in flat.items():
        want = leaf.transpose(3, 2, 0, 1) if path in convs else leaf
        np.testing.assert_array_equal(port[path].numpy(), want)
        assert port[path].shape == own[path].shape, path  # the port's own layout
    back = flatten_dict(interop.grads_to_jax_layout(
        interop.params_from_jax(tree, convs, device="cpu"), convs))
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], leaf)


def test_non_conv_4d_leaves_cross_unchanged():
    rng = np.random.default_rng(0)
    tree = {
        "layers": {"moe": {"wi": rng.standard_normal((2, 4, 8, 6)).astype(np.float32),
                           "wo": rng.standard_normal((2, 4, 6, 8)).astype(np.float32)},
                   "attn": {"q": {"w": rng.standard_normal((2, 8, 8)).astype(np.float32)}}},
        "conv0": {"w": rng.standard_normal((3, 3, 2, 5)).astype(np.float32)},
    }
    port = interop.params_from_jax(tree, ["conv0/w"], device="cpu")
    assert tuple(port["layers"]["moe"]["wi"].shape) == (2, 4, 8, 6)
    np.testing.assert_array_equal(port["layers"]["moe"]["wi"].numpy(), tree["layers"]["moe"]["wi"])
    assert tuple(port["conv0"]["w"].shape) == (5, 2, 3, 3)
    back = flatten_dict(interop.grads_to_jax_layout(port, ["conv0/w"]))
    for path, leaf in flatten_dict(tree).items():
        np.testing.assert_array_equal(back[path], leaf)


def test_conv_weight_of_the_wrong_rank_raises():
    with pytest.raises(ValueError, match="4-D"):
        interop.params_from_jax(
            {"stem": {"w": np.zeros((3, 4), np.float32)}}, ["stem/w"], device="cpu")


def test_layout_follows_the_model_not_the_leaf_name():
    """A 2-D Dense named like a conv crosses unchanged; a conv path the tree
    lacks is an error, not a silent no-op."""
    proj = np.arange(12, dtype=np.float32).reshape(3, 4)
    port = interop.params_from_jax({"proj": {"w": proj}}, (), device="cpu")
    np.testing.assert_array_equal(port["proj"]["w"].numpy(), proj)
    with pytest.raises(KeyError, match="patch_embed/w"):
        interop.grads_to_jax_layout({"proj": {"w": torch.zeros(3, 4)}}, ["patch_embed/w"])


@pytest.mark.parametrize("name", ["mixtral-8x7b", "arctic-480b"])
def test_moe_lm_trees_cross_leaf_by_leaf(name):
    jmodel = jbuild(JARCHS[name].reduced())
    tmodel = build_model(get_arch(name).reduced(), device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    flat = flatten_dict(tree)
    own = flatten_dict(tmodel.init(torch.Generator().manual_seed(0)))
    assert own.keys() == flat.keys()
    for path, leaf in flat.items():
        assert tuple(own[path].shape) == leaf.shape, path
        assert str(own[path].dtype).removeprefix("torch.") == str(leaf.dtype), path
    cfg = tmodel.cfg
    layers, e, d, f = cfg.n_layers, cfg.moe_experts, cfg.d_model, cfg.d_ff
    assert flat["layers/moe/wg"].shape == (layers, e, d, f)
    assert flat["layers/moe/wo"].shape == (layers, e, f, d)
    assert flat["layers/moe/router/w"].shape == (layers, d, e)
    assert ("layers/dense_mlp/wg/w" in flat) == bool(cfg.moe_dense_ff)
    params = interop.params_from_jax(tree, tmodel.conv_weights, device="cpu")
    back = flatten_dict(interop.grads_to_jax_layout(params, tmodel.conv_weights))
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
        np.testing.assert_array_equal(flatten_dict(params)[path].numpy(), leaf,
                                      err_msg=path)


@pytest.mark.parametrize("name", ["whisper-large-v3", "phi-3-vision-4.2b"])
def test_encdec_and_vlm_trees_cross_leaf_by_leaf(name):
    """Whisper's encoder and decoder stacks (cross-attention ``xattn``, its
    norm ``nx``, the encoder positions ``enc_pos``) and Phi-3-vision's
    ``prefix_proj`` cross unchanged, both ways."""
    jmodel = jbuild(JARCHS[name].reduced())
    tmodel = build_model(get_arch(name).reduced(), device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    flat = flatten_dict(tree)
    own = flatten_dict(tmodel.init(torch.Generator().manual_seed(0)))
    assert own.keys() == flat.keys()
    for path, leaf in flat.items():
        assert tuple(own[path].shape) == leaf.shape, path
    cfg = tmodel.cfg
    if cfg.family == "audio":
        d, layers = cfg.d_model, cfg.n_layers
        assert flat["enc_pos/e"].shape == (cfg.encoder_seq, d)
        assert flat["encoder/attn/q/w"].shape == (cfg.encoder_layers, d, d)
        assert flat["encoder/attn/q/b"].shape == (cfg.encoder_layers, d)  # qkv_bias
        assert flat["decoder/xattn/k/w"].shape == (layers, d, d)
        assert "decoder/xattn/k/b" not in flat  # the cross projections have no bias
        assert flat["decoder/nx/g"].shape == (layers, d)
    else:
        assert flat["prefix_proj/w"].shape == (cfg.prefix_dim, cfg.d_model)
        assert flat["prefix_proj/b"].shape == (cfg.d_model,)
    params = interop.params_from_jax(tree, tmodel.conv_weights, device="cpu")
    back = flatten_dict(interop.grads_to_jax_layout(params, tmodel.conv_weights))
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
