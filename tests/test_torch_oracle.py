"""The in-framework oracle in the port: every clipping mode against the
port's own ``vmap`` executor, and the port's ``vmap`` against the JAX
package's.

The paper's claim (Sec. 2.1) is that mixed ghost clipping is exactly
per-sample-gradient clipping, only cheaper.  ``vmap`` computes the latter by
its definition (``torch.func.vmap`` of ``grad_and_value`` of the one-sample
loss); every fused and ``*_taps`` mode must give the same per-sample norms
(within 5e-5, scaled by max(1, the largest norm), as
``tests/test_clipping_exactness.py`` holds the JAX package) and the same
clipped gradient sum (5e-5 absolute, scaled by max(1, the largest reference
entry)).  Models, at a small size with the same numpy weights and batches in
both packages: a narrow VGG, a small ResNet, the 2-layer reduced ViT
(stacked taps, LayerNorm scales, the position embedding) and an Embedding +
Dense + RMSNorm model like the JAX test's ``_MLPModel``.  The port's
``vmap`` is held to JAX's ``vmap`` at 1e-5 relative (norms and gradients).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.paper_native import VIT_BASE as JVIT_BASE
from repro.core import clipping as jclip
from repro.core.taps import Ctx as JCtx
from repro.models import cnn as jcnn
from repro.models import vit as jvit
from repro.nn import module as jmod
from repro_torch import interop
from repro_torch.configs.paper_native import VIT_BASE
from repro_torch.core import clipping as tclip
from repro_torch.core.taps import Ctx
from repro_torch.kernels import launches
from repro_torch.models import cnn as tcnn
from repro_torch.models import vit as tvit
from repro_torch.nn import module as tmod
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

CLIP_NORM = 0.3
TOL = 5e-5
VMAP_TOL = 1e-5
# every mode but the oracle itself and the baseline
MODES = [m for m in tclip.MODES if m not in ("vmap", "non_private")]
TINY_PLAN = (8, "M", 16, "M", 32, "M")
CPU = torch.device("cpu")


class JaxMLP:
    """Embedding + Dense (bias) + RMSNorm + Dense (no bias): the dense,
    embedding and scale tap kinds in a few hundred parameters."""

    def __init__(self, vocab=17, d=8, f=12):
        self.emb = jmod.Embedding("emb", vocab, d)
        self.l1 = jmod.Dense("l1", d, f, use_bias=True)
        self.norm = jmod.RMSNorm("n", f)
        self.l2 = jmod.Dense("l2", f, vocab, use_bias=False)
        self.conv_weights = ()

    def init(self, key):
        ks = jax.random.split(key, 4)
        return {"emb": self.emb.init(ks[0]), "l1": self.l1.init(ks[1]),
                "n": self.norm.init(ks[2]), "l2": self.l2.init(ks[3])}

    def loss_with_ctx(self, params, batch, ctx):
        x = self.emb(params["emb"], batch["tokens"], ctx.scope("emb"))
        h = jax.nn.gelu(self.l1(params["l1"], x, ctx.scope("l1")))
        h = self.norm(params["n"], h, ctx.scope("n"))
        logits = self.l2(params["l2"], h, ctx.scope("l2"))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, batch["labels"][..., None], axis=-1)[..., 0]
        return jnp.mean(nll * batch["mask"][:, None], axis=-1)


class TorchMLP:
    """The port's ``JaxMLP``: same paths, same math (tanh GELU, as
    ``jax.nn.gelu``)."""

    def __init__(self, vocab=17, d=8, f=12, device=CPU):
        self.device = device
        self.emb = tmod.Embedding("emb", vocab, d, device=device)
        self.l1 = tmod.Dense("l1", d, f, use_bias=True, device=device)
        self.norm = tmod.RMSNorm("n", f, device=device)
        self.l2 = tmod.Dense("l2", f, vocab, use_bias=False, device=device)
        self.conv_weights = ()

    def init(self, generator):
        return {"emb": self.emb.init(generator), "l1": self.l1.init(generator),
                "n": self.norm.init(generator), "l2": self.l2.init(generator)}

    def loss_with_ctx(self, params, batch, ctx):
        x = self.emb(params["emb"], batch["tokens"], ctx.scope("emb"))
        h = F.gelu(self.l1(params["l1"], x, ctx.scope("l1")), approximate="tanh")
        h = self.norm(params["n"], h, ctx.scope("n"))
        logits = self.l2(params["l2"], h, ctx.scope("l2"))
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
        return (nll * batch["mask"][:, None]).mean(dim=-1)


def lm_batch(rng, b=4, seq=6, vocab=17, mask=None):
    return {
        "tokens": rng.integers(0, vocab, size=(b, seq)).astype(np.int32),
        "labels": rng.integers(0, vocab, size=(b, seq)).astype(np.int32),
        "mask": np.ones((b,), np.float32) if mask is None else np.asarray(mask, np.float32),
    }


def image_batch(rng, b, image, mask=None):
    return {
        "image": rng.standard_normal((b, image, image, 3)).astype(np.float32),
        "label": rng.integers(0, 10, size=(b,)).astype(np.int32),
        "mask": np.ones((b,), np.float32) if mask is None else np.asarray(mask, np.float32),
    }


def pair(name, mask=None):
    """(JAX model, port model, JAX params, port params, numpy batch) of one
    oracle model.  Zero-initialised biases, gains' offsets and position
    tables are shifted so every leaf's gradient carries signal."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "vgg":
        jm, tm = jcnn.VGG("vgg_tiny"), tcnn.VGG("vgg_tiny", device=CPU)
        batch = image_batch(rng, 4, 16, mask)
    elif name == "resnet":
        jm, tm = jcnn.ResNet((1, 1), width=16), tcnn.ResNet((1, 1), width=16, device=CPU)
        batch = image_batch(rng, 3, 8, mask)
    elif name == "vit":
        jcfg = dataclasses.replace(JVIT_BASE.reduced(), n_layers=2)
        tcfg = dataclasses.replace(VIT_BASE.reduced(), n_layers=2)
        kw = dict(image_size=16, patch=4, n_classes=10)
        jm, tm = jvit.ViT(jcfg, **kw), tvit.ViT(tcfg, device=CPU, **kw)
        batch = image_batch(rng, 4, 16, mask)
    else:
        jm, tm = JaxMLP(), TorchMLP()
        batch = lm_batch(rng, mask=mask)
    flat = flatten_dict(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1))))
    for path, leaf in flat.items():
        if path.endswith("/b") or path.endswith("/e"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    np_params = unflatten_dict(flat)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = interop.params_from_jax(np_params, tm.conv_weights, device=CPU)
    return jm, tm, jparams, tparams, batch


@pytest.fixture(autouse=True)
def _tiny_vgg(monkeypatch):
    monkeypatch.setitem(jcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    monkeypatch.setitem(tcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)


def run_port(tm, tparams, batch, mode, policy=None):
    fn = tclip.dp_value_and_clipped_grad(
        tm.loss_with_ctx, tclip.ClipConfig(mode=mode, clip_norm=CLIP_NORM, policy=policy))
    return fn(tparams, interop.batch_from_numpy(batch, device=CPU))


def assert_matches_vmap(got, ref, what, tol=TOL):
    """Norms within tol * max(1, largest norm); gradients within tol *
    max(1, largest reference entry); the same mean loss."""
    loss, g, aux = got
    rloss, rg, raux = ref
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    scale = max(float(raux["per_sample_norms"].max()), 1.0)
    nerr = float((aux["per_sample_norms"] - raux["per_sample_norms"]).abs().max())
    assert nerr / scale < tol, (what, nerr, scale)
    flat, rflat = flatten_dict(g), flatten_dict(rg)
    assert flat.keys() == rflat.keys(), what
    gscale = max([1.0] + [float(v.abs().max()) for v in rflat.values()])
    for path, want in rflat.items():
        assert flat[path].shape == want.shape, (what, path)
        err = float((flat[path] - want).abs().max())
        assert err <= tol * gscale, (what, path, err, gscale)


@functools.lru_cache(maxsize=None)
def _vmap_reference(name):
    _, tm, _, tparams, batch = pair(name)
    return run_port(tm, tparams, batch, "vmap")


MODELS = ["vgg", "resnet", "vit", "mlp"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MODELS)
def test_mode_matches_the_port_vmap_oracle(name, mode):
    _, tm, _, tparams, batch = pair(name)
    got = run_port(tm, tparams, batch, mode)
    assert_matches_vmap(got, _vmap_reference(name), (name, mode))


@pytest.mark.parametrize("name", MODELS)
def test_port_vmap_matches_jax_vmap(name):
    """The port's per-sample-gradient oracle against the JAX package's:
    norms and clipped gradient sums within 1e-5 relative."""
    jm, tm, jparams, tparams, batch = pair(name)
    jfn = jax.jit(jclip.dp_value_and_clipped_grad(
        jm.loss_with_ctx, jclip.ClipConfig(mode="vmap", clip_norm=CLIP_NORM)))
    jloss, jg, jaux = jfn(jparams, batch)
    tloss, tg, taux = run_port(tm, tparams, batch, "vmap")
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(taux["per_sample_norms"].numpy(),
                               np.asarray(jaux["per_sample_norms"]), rtol=VMAP_TOL)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, tm.conv_weights))
    assert tflat.keys() == jflat.keys()
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    for path, want in jflat.items():
        err = float(np.abs(tflat[path] - want).max())
        assert err <= VMAP_TOL * scale, (name, path, err, scale)


def test_vmap_runs_no_tap_and_no_kernel():
    """The oracle's forward is under Ctx.disabled(): no probe, no kernel."""
    _, tm, _, tparams, batch = pair("vit")
    launches.reset()
    run_port(tm, tparams, batch, "vmap")
    assert all(v == {"cuda": 0, "torch": 0, "fake": 0} for v in launches.snapshot().values())


@pytest.mark.parametrize("mode", ["vmap", "mixed_ghost", "bk_mixed", "mixed_ghost_taps",
                                  "bk_mixed_taps"])
def test_poisson_mask_zeroes_contributions(mode):
    """Samples out of the Poisson draw get factor 0 in every mode, and the
    mode still matches the oracle (and, for vmap, JAX's vmap)."""
    mask = [1.0, 0.0, 1.0, 0.0]
    jm, tm, jparams, tparams, batch = pair("mlp", mask=mask)
    got = run_port(tm, tparams, batch, mode)
    assert got[2]["clip_factors"][1] == 0 and got[2]["clip_factors"][3] == 0
    assert_matches_vmap(got, run_port(tm, tparams, batch, "vmap"), mode)
    if mode == "vmap":
        jfn = jclip.dp_value_and_clipped_grad(
            jm.loss_with_ctx, jclip.ClipConfig(mode="vmap", clip_norm=CLIP_NORM))
        _, jg, _ = jax.jit(jfn)(jparams, batch)
        for path, want in flatten_dict(jax.tree_util.tree_map(np.asarray, jg)).items():
            np.testing.assert_allclose(flatten_dict(got[1])[path].numpy(), want,
                                       rtol=1e-5, atol=1e-7, err_msg=path)


def test_coverage_validation_catches_untapped_params():
    """A layer applied outside the taps escapes the tap engines (it would
    escape clipping): validate_coverage names it in both packages."""
    jm, tm, jparams, tparams, batch = pair("mlp")

    def leaky(model, disabled, gelu):
        def loss(params, b, ctx):
            x = model.emb(params["emb"], b["tokens"], ctx.scope("emb"))
            h = gelu(model.l1(params["l1"], x, disabled()))
            h = model.norm(params["n"], h, ctx.scope("n"))
            return model.l2(params["l2"], h, ctx.scope("l2")).mean(axis=(1, 2))
        return loss

    tmeta = tclip.discover_meta(leaky(tm, Ctx.disabled, F.gelu), tparams,
                                interop.batch_from_numpy(batch, device=CPU))
    jmeta = jclip.discover_meta(leaky(jm, JCtx.disabled, jax.nn.gelu), jparams, batch)
    assert tclip.validate_coverage(tmeta, tparams) == ["l1/b", "l1/w"]
    assert jclip.validate_coverage(jmeta, jparams) == ["l1/b", "l1/w"]


@pytest.mark.parametrize("name", ["vgg", "vit"])
def test_taps_engine_records_every_tap_once_per_layer(name):
    """Under the explicit engine each tap keeps its input and its
    pre-activation under (name, layer) keys; the meta is the discovered
    one (stacked for the ViT's layers)."""
    _, tm, _, tparams, batch = pair(name)
    tb = interop.batch_from_numpy(batch, device=CPU)
    meta = tclip.discover_meta(tm.loss_with_ctx, tparams, tb)
    ctx = Ctx(meta={}, acts={})
    tm.loss_with_ctx(tparams, tb, ctx)
    assert ctx.meta == meta
    want = {(n, layer) for n, m in meta.items()
            for layer in ([None] if not m.stack_dims else range(m.n_stack))}
    assert set(ctx.acts) == set(ctx.zs) == want
    for (tap, layer), a in ctx.acts.items():
        m = meta[tap]
        lead = 0 if layer is None else len(m.stack_dims)
        assert tuple(a.shape) == m.a_shape[lead:], (tap, layer)
        assert tuple(ctx.zs[(tap, layer)].shape) == m.s_shape[lead:], (tap, layer)
