"""The port's DP-SGD step on the ViT, held against the JAX package.

ViT-Base/16's topology (``VIT_BASE.reduced()`` cut to 2 layers: d_model 64,
4 heads, d_ff 96, qkv bias, LayerNorm, tanh GELU) with the same numpy
weights (``repro_torch.interop``) and the same numpy batch in both packages
on the CPU.  Two image/patch cases: 16/4 gives T = 16 patches, 20/4 gives
T = 25, a ragged tile.  Compared: the mean loss and the per-sample norms
(rtol 1e-5) and the clipped gradient sum (5e-5 absolute, relative to the
reference gradient where it exceeds 1), as ``test_torch_cnn_step.py``
holds the CNNs.  The ViT's taps cover every stacked kind: dense and conv
``matmul``, LayerNorm ``scale`` with bias, and the ``embedding`` of the
position table.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_native import VIT_BASE as JVIT_BASE
from repro.core import clipping as jclip
from repro.core.decision import decide as jdecide
from repro.launch import steps as jsteps
from repro.models import vit as jvit
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch.configs.paper_native import VIT_BASE
from repro_torch.core import clipping as tclip
from repro_torch.core.decision import decide as tdecide
from repro_torch.core.engine import PrivacyEngine
from repro_torch.kernels import launches
from repro_torch.launch import steps as tsteps
from repro_torch.models import vit as tvit
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils.tree import flatten_dict, unflatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

CLIP_MODES = ["non_private", "ghost", "fastgradclip", "mixed_ghost", "bk_mixed"]
IMAGES = [(16, 4), (20, 4)]  # (image, patch): T = 16 and T = 25 patches
N_CLASSES = 10


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(JVIT_BASE.reduced(), n_layers=2, dtype=dtype)
    tcfg = dataclasses.replace(VIT_BASE.reduced(), n_layers=2, dtype=dtype)
    return jcfg, tcfg


def _models(image, patch, dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    kw = dict(image_size=image, patch=patch, n_classes=N_CLASSES)
    return jvit.ViT(jcfg, **kw), tvit.ViT(tcfg, device="cpu", **kw)


def _batch(rng, b, image, mask=None):
    return {
        "image": rng.standard_normal((b, image, image, 3)).astype(np.float32),
        "label": rng.integers(0, N_CLASSES, size=(b,)).astype(np.int32),
        "mask": np.ones((b,), np.float32) if mask is None else np.asarray(mask, np.float32),
    }


def _pair(jmodel, tmodel, seed):
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    # a zero position table and zero biases give zero-sum gradients; shift
    # them so every leaf's gradient carries signal
    rng = np.random.default_rng(seed)
    flat = flatten_dict(np_params)
    for path, leaf in flat.items():
        if path.endswith("/b") or path.endswith("/e"):
            flat[path] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    np_params = unflatten_dict(flat)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    return jparams, interop.params_from_jax(np_params, tmodel.conv_weights, device="cpu")


def _run_both(jmodel, tmodel, jparams, tparams, batch, mode):
    cfg = dict(mode=mode, clip_norm=0.3)
    jres = jax.jit(jclip.dp_value_and_clipped_grad(jmodel.loss_with_ctx, jclip.ClipConfig(**cfg)))(
        jparams, batch
    )
    tres = tclip.dp_value_and_clipped_grad(tmodel.loss_with_ctx, tclip.ClipConfig(**cfg))(
        tparams, interop.batch_from_numpy(batch, device="cpu")
    )
    return jres, tres


def _assert_step_matches(jres, tres, conv_weights, *, rtol=1e-5, grad_tol=5e-5):
    jloss, jg, jaux = jres
    tloss, tg, taux = tres
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    jn = np.asarray(jaux["per_sample_norms"])
    tn = taux["per_sample_norms"].numpy()
    np.testing.assert_allclose(tn, jn, rtol=rtol, atol=1e-6)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, conv_weights))
    assert tflat.keys() == jflat.keys()
    scale = max([1.0] + [float(np.abs(v).max()) for v in jflat.values()])
    for path, want in jflat.items():
        got = tflat[path]
        assert got.shape == want.shape, path
        err = float(np.abs(got.astype(np.float32) - want.astype(np.float32)).max())
        assert err <= grad_tol * scale, (path, err, scale)


@pytest.mark.parametrize("image,patch", IMAGES)
def test_vit_taps_and_decisions_match_jax(image, patch):
    """Same tap names, kinds, (T, D, p), param paths and stack dims; the
    layerwise decisions agree per tap and mode."""
    jmodel, tmodel = _models(image, patch)
    jparams, tparams = _pair(jmodel, tmodel, 0)
    batch = _batch(np.random.default_rng(0), 2, image)
    jmeta = jclip.discover_meta(jmodel.loss_with_ctx, jparams, batch)
    tmeta = tclip.discover_meta(
        tmodel.loss_with_ctx, tparams, interop.batch_from_numpy(batch, device="cpu")
    )
    assert tmeta.keys() == jmeta.keys()
    kinds = set()
    for name, jm in jmeta.items():
        tm = tmeta[name]
        assert (tm.kind, tm.T, tm.D, tm.p, tm.param_path, tm.bias_path, tm.stack_dims) == (
            jm.kind, jm.T, jm.D, jm.p, jm.param_path, jm.bias_path, jm.stack_dims), name
        assert tm.s_shape == jm.s_shape, name
        kinds.add(tm.kind)
        for mode in ("mixed_ghost", "bk_mixed", "ghost", "fastgradclip"):
            assert tdecide(tm, mode=mode) == jdecide(jm, mode=mode), (name, mode)
    assert kinds == {"matmul", "scale", "embedding"}
    assert tmeta["layers/attn/q/out"].stack_dims == (2,)
    assert tmeta["pos_embed/out"].T == (image // patch) ** 2
    validate = PrivacyEngine(
        loss_with_ctx=tmodel.loss_with_ctx, batch_size=2, sample_size=100, steps=1,
        max_grad_norm=1.0, noise_multiplier=1.0, device="cpu",
    )
    validate.validate(tparams, interop.batch_from_numpy(batch, device="cpu"))


@pytest.mark.parametrize("mode", CLIP_MODES)
@pytest.mark.parametrize("image,patch", IMAGES)
def test_vit_clipped_step_matches_jax(image, patch, mode):
    jmodel, tmodel = _models(image, patch)
    jparams, tparams = _pair(jmodel, tmodel, 1)
    batch = _batch(np.random.default_rng(1), 3, image, mask=[1, 0, 1])
    _assert_step_matches(*_run_both(jmodel, tmodel, jparams, tparams, batch, mode),
                         tmodel.conv_weights)


@pytest.mark.parametrize("mode", ["non_private", "mixed_ghost", "bk_mixed"])
def test_vit_bf16_step_matches_jax(mode):
    """bf16 compute with fp32 parameters, as ViT-Base runs.

    The loss and the per-sample norms are held against the JAX package's
    bf16 step at rtol 1e-2: the two frameworks round to bf16 at different
    places (matmul outputs, residual adds, casts of fp32 statistics), each
    rounding moving a value by up to 2^-9, and two blocks compound a few of
    them.  The clipped gradients are held against the JAX package's fp32
    step on the same weights, at 2e-2 of the largest entry (about five bf16
    roundings): the JAX bf16 step is no reference for them, since XLA's CPU
    reductions sum its bias gradients in bf16 (``norm_f/b`` lands 3.3% of
    the largest entry from its own fp32 value in ``non_private``).
    """
    jmodel, tmodel = _models(20, 4, dtype="bfloat16")
    jmodel32, _ = _models(20, 4)
    jparams, tparams = _pair(jmodel, tmodel, 2)
    for path, leaf in flatten_dict(tparams).items():
        assert leaf.dtype == torch.float32, path
    batch = _batch(np.random.default_rng(2), 3, 20)
    (jloss, _, jaux), (tloss, tg, taux) = _run_both(jmodel, tmodel, jparams, tparams, batch, mode)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)
    np.testing.assert_allclose(taux["per_sample_norms"].numpy(),
                               np.asarray(jaux["per_sample_norms"]), rtol=1e-2)
    cfg = jclip.ClipConfig(mode=mode, clip_norm=0.3)
    _, jg32, _ = jax.jit(jclip.dp_value_and_clipped_grad(jmodel32.loss_with_ctx, cfg))(
        jparams, batch)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg32))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, tmodel.conv_weights))
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    for path, want in jflat.items():
        assert tflat[path].dtype == np.float32, path
        err = float(np.abs(tflat[path] - want).max())
        assert err <= 2e-2 * scale, (path, err, scale)


def _expected_calls(meta, mode):
    """Kernel calls of one clipped step, from the taps and their decisions:
    a norm per layer of every ghost-branch tap, one book contraction per
    ghost-banked (stacked) tap, and one grouped contraction of every
    psg-banked weight and bias of the step."""
    calls = dict.fromkeys(launches.KERNELS, 0)
    for m in meta.values():
        ghost = tdecide(m, mode=mode) == "ghost"
        if m.kind == "embedding":
            calls["embedding_ghost_norm_sq"] += m.n_stack
        elif m.kind == "matmul" and ghost:
            calls["ghost_norm_sq"] += m.n_stack
            calls["book_weighted_grad"] += mode == "bk_mixed"
        elif mode == "bk_mixed":
            calls["psg_contract"] = 1
    return calls


@pytest.mark.parametrize("image,patch", IMAGES)
def test_vit_per_step_kernel_calls(image, patch):
    """Every layer's probe norms its tap once (the second backward computes
    no banks); bk_mixed contracts each stacked tap's banks once."""
    jmodel, tmodel = _models(image, patch)
    _, tparams = _pair(jmodel, tmodel, 3)
    batch = interop.batch_from_numpy(_batch(np.random.default_rng(3), 2, image), device="cpu")
    meta = tclip.discover_meta(tmodel.loss_with_ctx, tparams, batch)
    for mode in ("mixed_ghost", "bk_mixed"):
        fn = tclip.dp_value_and_clipped_grad(tmodel.loss_with_ctx, tclip.ClipConfig(mode=mode))
        launches.reset()
        fn(tparams, batch)
        snap = launches.snapshot()
        assert all(v["cuda"] == 0 for v in snap.values())
        assert {k: v["torch"] for k, v in snap.items()} == _expected_calls(meta, mode), mode
    # T = 16 banks every matmul as a book, as ViT-Base does; T = 25 banks the
    # attention projections and the patch embedding as per-sample gradients
    bk = {tdecide(m, mode="bk_mixed") for m in meta.values() if m.kind == "matmul"}
    assert bk == ({"ghost"} if image == 16 else {"ghost", "instantiate"})


def test_vit_bk_mixed_contracts_every_psg_bank_in_one_call(monkeypatch):
    """At T = 25 the attention projections and the patch embedding bank
    per-sample gradients: one bk_mixed step hands every such bank of both
    layers to one grouped contraction, a stacked tap's layers as separate
    (B, F) segments in the order ghost.psg_segment_sizes gives, each a
    contiguous view of the probe's own bank (nothing stacks or moves it)."""
    from repro_torch.core import ghost as tghost
    from repro_torch.kernels import dispatch

    jmodel, tmodel = _models(20, 4)
    _, tparams = _pair(jmodel, tmodel, 5)
    batch = interop.batch_from_numpy(_batch(np.random.default_rng(5), 3, 20), device="cpu")
    meta = tclip.discover_meta(tmodel.loss_with_ctx, tparams, batch)
    calls = []
    real = dispatch.psg_contract_grouped

    def spy(psgs, c, **kw):
        calls.append([(tuple(x.shape), x.is_contiguous()) for x in psgs])
        return real(psgs, c, **kw)

    monkeypatch.setattr(dispatch, "psg_contract_grouped", spy)
    fn = tclip.dp_value_and_clipped_grad(tmodel.loss_with_ctx, tclip.ClipConfig(mode="bk_mixed"))
    fn(tparams, batch)
    sizes = [f for m in meta.values()
             if m.kind in ("scale", "bias")
             or (m.kind == "matmul" and tdecide(m, mode="bk_mixed") == "instantiate")
             for f in tghost.psg_segment_sizes(m)]
    assert len(calls) == 1 and len(calls[0]) == len(sizes) > 2
    assert calls[0] == [((3, f), True) for f in sizes]


def test_vit_base_decisions_at_full_width():
    """ViT-Base/16 at 224x224, batch 32 (T = 196): every matmul tap takes
    the ghost norm in mixed_ghost and banks its (a, g) book in bk_mixed, so
    a step runs 1 + 6 x 12 + 1 ghost norms, 1 embedding norm and, in
    bk_mixed, 8 book contractions and one grouped contraction of the 50
    per-sample gradient banks of the norms' scales and biases (from the tap
    dims alone; the full-width forward runs on the card, in
    chip_smoke.py)."""
    from repro_torch.core.taps import TapMeta

    b, t, d, ff = 32, 196, 768, 3072

    def tap(kind, t_, d_in, d_out, n_layers=0, bias=True, a_shape=None):
        m = TapMeta(kind=kind, T=t_, D=d_in, p=d_out, s_shape=(b, t_, d_out),
                    s_dtype=torch.bfloat16, param_path="w", bias_path="b" if bias else None,
                    batch_size=b, a_shape=a_shape or (b, t_, d_in), a_dtype=torch.bfloat16)
        return m.with_stack(n_layers) if n_layers else m

    meta = {
        "patch_embed": tap("matmul", t, 3 * 16 * 16, d, a_shape=(b, 224, 224, 3)),
        "pos_embed": tap("embedding", t, t, d, bias=False, a_shape=(b, t)),
        **{f"layers/{n}": tap("matmul", t, d, d, 12, bias=n != "o") for n in "qkvo"},
        "layers/wi": tap("matmul", t, d, ff, 12),
        "layers/wo": tap("matmul", t, ff, d, 12),
        **{f"layers/{n}": tap("scale", t, d, d, 12) for n in ("n1", "n2")},
        "norm_f": tap("scale", t, d, d),
        "head": tap("matmul", 1, d, 10),
    }
    for mode in ("mixed_ghost", "bk_mixed"):
        assert all(tdecide(m, mode=mode) == "ghost" for m in meta.values()
                   if m.kind == "matmul"), mode
    assert _expected_calls(meta, "mixed_ghost") == {
        "ghost_norm_sq": 74, "embedding_ghost_norm_sq": 1,
        "book_weighted_grad": 0, "psg_contract": 0, "flash_attention": 0}
    assert _expected_calls(meta, "bk_mixed") == {
        "ghost_norm_sq": 74, "embedding_ghost_norm_sq": 1,
        "book_weighted_grad": 8, "psg_contract": 1, "flash_attention": 0}


def test_vit_train_step_matches_jax():
    """One noiseless make_train_step in bk_mixed (clip -> /logical batch -> SGD)."""
    jmodel, tmodel = _models(16, 4)
    jparams, tparams = _pair(jmodel, tmodel, 4)
    batch = _batch(np.random.default_rng(4), 3, 16)
    dp = dict(clipping_mode="bk_mixed", clip_norm=0.5, noise_multiplier=0.0, logical_batch=3)
    jo, to = jopt.sgd(), topt.sgd()
    jstep = jax.jit(jsteps.make_train_step(jmodel, jo, lambda s: 0.1, jsteps.DPTrainConfig(**dp)))
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jax.numpy.zeros((), jax.numpy.int32), "rng": jax.random.PRNGKey(0)}
    jnew, jmet = jstep(jstate, batch)
    tstep = tsteps.make_train_step(
        tmodel, to, tsched.constant(0.1), tsteps.DPTrainConfig(**dp), device="cpu"
    )
    tstate = {"params": tparams, "opt": to.init(tparams), "step": 0,
              "rng": torch.Generator().manual_seed(0)}
    tnew, tmet = tstep(tstate, interop.batch_from_numpy(batch, device="cpu"))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jnew["params"]))
    tflat = flatten_dict(interop.grads_to_jax_layout(tnew["params"], tmodel.conv_weights))
    for path, want in jflat.items():
        np.testing.assert_allclose(tflat[path], want, rtol=1e-5, atol=1e-6, err_msg=path)


def test_vit_privacy_engine_flow():
    """PrivacyEngine on the ViT: coverage, the clipped sum in bk_mixed equal
    to mixed_ghost's, and a seeded privatized gradient in parameter shapes."""
    from repro_torch.core.accountant import compute_epsilon

    jmodel, tmodel = _models(16, 4)
    _, tparams = _pair(jmodel, tmodel, 5)
    batch = interop.batch_from_numpy(_batch(np.random.default_rng(5), 3, 16), device="cpu")
    kw = dict(loss_with_ctx=tmodel.loss_with_ctx, batch_size=3, sample_size=1000, steps=10,
              max_grad_norm=0.5, noise_multiplier=1.1, device="cpu")
    engines = {mode: PrivacyEngine(mode=mode, **kw) for mode in ("mixed_ghost", "bk_mixed")}
    engines["bk_mixed"].validate(tparams, batch)
    res = {mode: e.clipped_grad_fn()(tparams, batch) for mode, e in engines.items()}
    torch.testing.assert_close(res["bk_mixed"][2]["per_sample_norms"],
                               res["mixed_ghost"][2]["per_sample_norms"], rtol=1e-5, atol=0)
    gsum = res["bk_mixed"][1]
    for path, g in flatten_dict(gsum).items():
        torch.testing.assert_close(g, flatten_dict(res["mixed_ghost"][1])[path],
                                   rtol=1e-4, atol=1e-6)
    noisy = engines["bk_mixed"].privatize(gsum, torch.Generator().manual_seed(1))
    again = engines["bk_mixed"].privatize(gsum, torch.Generator().manual_seed(1))
    for path, g in flatten_dict(noisy).items():
        assert g.shape == flatten_dict(tparams)[path].shape, path
        torch.testing.assert_close(g, flatten_dict(again)[path], rtol=0, atol=0)
    engines["bk_mixed"].record_step(2)
    eps, delta = engines["bk_mixed"].privacy_spent()
    assert eps == compute_epsilon(q=3 / 1000, sigma=1.1, steps=2, delta=delta)


def test_config_copy_matches_jax():
    """The port's ArchConfig copy: same fields, defaults and reduction."""
    from repro.configs.paper_native import BEIT_LARGE as JBEIT
    from repro_torch.configs.paper_native import BEIT_LARGE

    for jc, tc in ((JVIT_BASE, VIT_BASE), (JBEIT, BEIT_LARGE)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
        assert tc.resolved_head_dim == jc.resolved_head_dim
