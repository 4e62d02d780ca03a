"""The port's DP-SGD step on the CNNs, held against the JAX package.

The same numpy weights (moved across with ``repro_torch.interop``) and the
same numpy batch go through both packages on the CPU.  Compared: the mean
loss (rtol 1e-5), the per-sample norms (rtol 1e-5) and the clipped gradient
sum (5e-5 absolute, as in ``test_clipping_exactness.py``, relative to the
reference gradient where it exceeds 1), in
``non_private``, ``mixed_ghost`` and ``bk_mixed``.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import clipping as jclip
from repro.core.decision import decide as jdecide
from repro.launch import steps as jsteps
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro_torch import interop
from repro_torch.core import clipping as tclip
from repro_torch.core.accountant import compute_epsilon
from repro_torch.core.engine import PrivacyEngine
from repro_torch.kernels import launches
from repro_torch.launch import steps as tsteps
from repro_torch.models import cnn as tcnn
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.utils.tree import flatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401

MODES = ["non_private", "mixed_ghost", "bk_mixed"]
# the fused engine's fixed-branch modes share its code; held equal too
CLIP_MODES = MODES + ["ghost", "fastgradclip"]
TINY_PLAN = (8, "M", 16, "M", 32, "M")


@pytest.fixture
def tiny_vgg_plan(monkeypatch):
    """A narrow VGG registered in both packages for the length of a test."""
    monkeypatch.setitem(jcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    monkeypatch.setitem(tcnn.VGG_PLANS, "vgg_tiny", TINY_PLAN)
    return "vgg_tiny"


def _batch(rng, b, image, mask=None):
    return {
        "image": rng.standard_normal((b, image, image, 3)).astype(np.float32),
        "label": rng.integers(0, 10, size=(b,)).astype(np.int32),
        "mask": np.ones((b,), np.float32) if mask is None else np.asarray(mask, np.float32),
    }


def _pair(jmodel, tmodel, seed):
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, interop.params_from_jax(np_params, tmodel.conv_weights, device="cpu")


def _assert_step_matches(jres, tres, conv_weights):
    jloss, jg, jaux = jres
    tloss, tg, taux = tres
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jn = np.asarray(jaux["per_sample_norms"])
    tn = taux["per_sample_norms"].numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-5, atol=1e-6)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, conv_weights))
    assert tflat.keys() == jflat.keys()
    # absolute 5e-5 for clipped gradients, as test_clipping_exactness.py
    # holds them; scaled up only by the reference gradient's own magnitude
    scale = max([1.0] + [float(np.abs(v).max()) for v in jflat.values()])
    for path, want in jflat.items():
        assert tflat[path].shape == want.shape, path
        err = float(np.abs(tflat[path] - want).max())
        assert err <= 5e-5 * scale, (path, err, scale)


def _run_both(jmodel, tmodel, jparams, tparams, batch, mode):
    cfg = dict(mode=mode, clip_norm=0.3)
    jres = jax.jit(jclip.dp_value_and_clipped_grad(jmodel.loss_with_ctx, jclip.ClipConfig(**cfg)))(
        jparams, batch
    )
    tres = tclip.dp_value_and_clipped_grad(tmodel.loss_with_ctx, tclip.ClipConfig(**cfg))(
        tparams, interop.batch_from_numpy(batch, device="cpu")
    )
    return jres, tres


def test_tiny_vgg_exercises_both_branches(tiny_vgg_plan):
    """The narrow VGG at 16x16 has ghost and instantiate taps in both modes."""
    jmodel = jcnn.VGG(tiny_vgg_plan)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0), 2, 16)
    meta = jclip.discover_meta(jmodel.loss_with_ctx, jparams, batch)
    for mode in ("mixed_ghost", "bk_mixed"):
        branches = {jdecide(m, mode=mode) for m in meta.values() if m.kind == "matmul"}
        assert branches == {"ghost", "instantiate"}, mode


@pytest.mark.parametrize("mode", CLIP_MODES)
def test_vgg_clipped_step_matches_jax(tiny_vgg_plan, mode):
    jmodel = jcnn.VGG(tiny_vgg_plan)
    tmodel = tcnn.VGG(tiny_vgg_plan, device="cpu")
    jparams, tparams = _pair(jmodel, tmodel, 1)
    batch = _batch(np.random.default_rng(1), 4, 16, mask=[1, 0, 1, 1])
    _assert_step_matches(*_run_both(jmodel, tmodel, jparams, tparams, batch, mode),
                         tmodel.conv_weights)


@pytest.mark.parametrize("mode", CLIP_MODES)
def test_resnet_clipped_step_matches_jax(mode):
    """Stride-2 convs on even inputs: XLA's SAME pads (0, 1), which the
    port's conv, unfold and per-sample conv gradients must all follow."""
    jmodel = jcnn.ResNet((1, 1), width=16)
    tmodel = tcnn.ResNet((1, 1), width=16, device="cpu")
    jparams, tparams = _pair(jmodel, tmodel, 2)
    batch = _batch(np.random.default_rng(2), 3, 8)
    _assert_step_matches(*_run_both(jmodel, tmodel, jparams, tparams, batch, mode),
                         tmodel.conv_weights)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(tiny_vgg_plan, mode):
    """One noiseless make_train_step (clip -> /logical batch -> SGD update)."""
    jmodel = jcnn.VGG(tiny_vgg_plan)
    tmodel = tcnn.VGG(tiny_vgg_plan, device="cpu")
    jparams, tparams = _pair(jmodel, tmodel, 3)
    batch = _batch(np.random.default_rng(3), 4, 16)
    dp = dict(clipping_mode=mode, clip_norm=0.5, noise_multiplier=0.0, logical_batch=4)
    jo, to = jopt.sgd(), topt.sgd()
    jstep = jax.jit(jsteps.make_train_step(
        jmodel, jo, lambda s: 0.1, jsteps.DPTrainConfig(**dp)
    ))
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jax.numpy.zeros((), jax.numpy.int32), "rng": jax.random.PRNGKey(0)}
    jnew, jmet = jstep(jstate, batch)
    tstep = tsteps.make_train_step(
        tmodel, to, tsched.constant(0.1), tsteps.DPTrainConfig(**dp), device="cpu"
    )
    tstate = {"params": tparams, "opt": to.init(tparams), "step": 0,
              "rng": torch.Generator().manual_seed(0)}
    tnew, tmet = tstep(tstate, interop.batch_from_numpy(batch, device="cpu"))
    assert tnew["step"] == 1
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jnew["params"]))
    tflat = flatten_dict(interop.grads_to_jax_layout(tnew["params"], tmodel.conv_weights))
    for path, want in jflat.items():
        np.testing.assert_allclose(tflat[path], want, rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("arch", ["vgg11", "vgg19", "resnet18"])
def test_taps_and_decisions_match_jax(arch):
    """Same tap names, param paths and (T, D, p) per tap; the copied cost
    model and decision rule agree on every tap and in total (Table 2)."""
    from repro.core import decision as jdec
    from repro_torch.core import decision as tdec

    if arch == "resnet18":
        jmodel, tmodel = jcnn.ResNet(), tcnn.ResNet(device="cpu")
    else:
        jmodel, tmodel = jcnn.VGG(arch), tcnn.VGG(arch, device="cpu")
    batch = _batch(np.random.default_rng(6), 2, 32)
    jmeta = jclip.discover_meta(jmodel.loss_with_ctx, jmodel.init(jax.random.PRNGKey(0)), batch)
    tmeta = tclip.discover_meta(
        tmodel.loss_with_ctx, tmodel.init(torch.Generator().manual_seed(0)),
        interop.batch_from_numpy(batch, device="cpu"),
    )
    assert tmeta.keys() == jmeta.keys()
    for name, jm in jmeta.items():
        tm = tmeta[name]
        assert (tm.kind, tm.T, tm.D, tm.p, tm.param_path, tm.bias_path) == (
            jm.kind, jm.T, jm.D, jm.p, jm.param_path, jm.bias_path), name
        assert math.prod(tm.a_shape) == math.prod(jm.a_shape), name
        for mode in ("mixed_ghost", "bk_mixed", "ghost", "fastgradclip"):
            assert tdec.decide(tm, mode=mode) == jdec.decide(jm, mode=mode), (name, mode)
    for mode in ("non_private", "opacus", "mixed_ghost", "bk_mixed", "fastgradclip"):
        assert tdec.algorithm_cost(tmeta, mode) == jdec.algorithm_cost(jmeta, mode), mode


def _vgg19_counts(mode):
    model = tcnn.VGG("vgg19", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = interop.batch_from_numpy(_batch(np.random.default_rng(4), 2, 32), device="cpu")
    fn = tclip.dp_value_and_clipped_grad(model.loss_with_ctx, tclip.ClipConfig(mode=mode))
    launches.reset()
    _, _, aux = fn(params, batch)
    counts = {k: v["torch"] for k, v in launches.snapshot().items()}
    assert all(v["cuda"] == 0 for v in launches.snapshot().values())
    return counts, aux["per_sample_norms"]


def test_vgg19_per_step_kernel_calls():
    """VGG-19 (CIFAR-10 widths): 14 ghost taps in mixed_ghost, each normed
    once (the second backward computes no banks); bk_mixed ghost-banks 13
    taps and contracts the 40 per-sample gradient banks of 4 psg-banked
    convs + 16 GroupNorms, weight and bias, in one grouped call."""
    mixed, n_mixed = _vgg19_counts("mixed_ghost")
    assert mixed == {"ghost_norm_sq": 14, "embedding_ghost_norm_sq": 0,
                     "book_weighted_grad": 0, "psg_contract": 0, "flash_attention": 0}
    bk, n_bk = _vgg19_counts("bk_mixed")
    assert bk == {"ghost_norm_sq": 13, "embedding_ghost_norm_sq": 0,
                  "book_weighted_grad": 13, "psg_contract": 1, "flash_attention": 0}
    torch.testing.assert_close(n_bk, n_mixed, rtol=1e-5, atol=0)


def test_privacy_engine_flow_on_cpu(tiny_vgg_plan):
    model = tcnn.VGG(tiny_vgg_plan, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = interop.batch_from_numpy(_batch(np.random.default_rng(5), 4, 16), device="cpu")
    engine = PrivacyEngine(
        loss_with_ctx=model.loss_with_ctx, batch_size=4, sample_size=1000, steps=10,
        max_grad_norm=0.1, noise_multiplier=1.1, mode="bk_mixed", device="cpu",
    )
    engine.validate(params, batch)
    loss, gsum, aux = engine.clipped_grad_fn()(params, batch)
    assert torch.all(aux["per_sample_norms"] > 0)
    noisy = engine.privatize(gsum, torch.Generator().manual_seed(1))
    again = engine.privatize(gsum, torch.Generator().manual_seed(1))
    for path, g in flatten_dict(noisy).items():
        assert g.shape == flatten_dict(params)[path].shape
        torch.testing.assert_close(g, flatten_dict(again)[path], rtol=0, atol=0)
    engine.record_step(3)
    eps, delta = engine.privacy_spent()
    assert eps == compute_epsilon(q=4 / 1000, sigma=1.1, steps=3, delta=delta)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adam", {}), ("adam", {"weight_decay": 0.01}),
])
def test_optimizer_updates_match_jax(name, kw):
    """Three steps of each optimizer on the same numpy params and grads.

    (Compared directly, not through a train step: the conv biases in front
    of per-channel GroupNorms get rounding-noise gradients, which Adam's
    normalization blows up to +-lr.)"""
    rng = np.random.default_rng(8)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal((5,)).astype(np.float32)}
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp, tp = params, interop.params_from_jax(params, (), device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
        ju, js = jo.update(grads, js, jp, jax.numpy.asarray(step), 0.01)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(interop.params_from_jax(grads, (), device="cpu"), ts, tp, step, 0.01)
        tp = topt.apply_updates(tp, tu)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jp))
    # fp32 state; the port takes Adam's bias corrections in float64 on the
    # host, JAX in float32 on the device
    for path, got in flatten_dict(interop.grads_to_jax_layout(tp, ())).items():
        np.testing.assert_allclose(got, jflat[path], rtol=1e-5, atol=1e-6, err_msg=path)


def test_poisson_mask_and_synthetic_batch_are_seeded():
    from repro_torch.data.poisson import poisson_sample_mask
    from repro_torch.data.synthetic import synthetic_vision_batch

    masks = [poisson_sample_mask(torch.Generator().manual_seed(7), 4000, 0.1) for _ in range(2)]
    torch.testing.assert_close(masks[0], masks[1], rtol=0, atol=0)
    assert set(masks[0].unique().tolist()) <= {0.0, 1.0}
    assert abs(float(masks[0].mean()) - 0.125) < 0.02  # q * slots_per_sample
    kw = dict(batch=3, image=8, channels=3, n_classes=10, device="cpu")
    a, b = synthetic_vision_batch(step=0, **kw), synthetic_vision_batch(step=0, **kw)
    c = synthetic_vision_batch(step=1, **kw)
    assert a["image"].shape == (3, 8, 8, 3) and a["label"].shape == (3,)
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)
    assert not torch.equal(a["image"], c["image"])


def test_entry_points_refuse_cpu_unless_asked(tiny_vgg_plan, monkeypatch):
    """No GPU and no explicit device: every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.VGG(tiny_vgg_plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.ResNet((1, 1), width=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrivacyEngine(loss_with_ctx=None, batch_size=4, sample_size=100, steps=1,
                      max_grad_norm=1.0, noise_multiplier=1.0)
    model = tcnn.VGG(tiny_vgg_plan, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsteps.make_train_step(model, topt.sgd(), tsched.constant(0.1), tsteps.DPTrainConfig())
    state = tsteps.make_train_state(model, 0, topt.sgd())
    assert flatten_dict(state["params"])["conv0/w"].device.type == "cpu"


def test_cuda_device_carries_its_index(monkeypatch):
    """"cuda" resolves to "cuda:<current>", the device tensors report, so
    the train step's device checks compare like with like."""
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
