"""Small pieces of the port's clipping core, held against the JAX package:
clip functions, learning-rate schedules, coverage validation, every
clipping mode accepted, and the tap kinds that wait for later slices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as jclip
from repro.core import functions as jfn
from repro.optim import schedules as jsched
from repro_torch.core import clipping as tclip
from repro_torch.core import functions as tfn
from repro_torch.core import ghost as tghost
from repro_torch.core.taps import TapMeta
from repro_torch.optim import schedules as tsched
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("name", sorted(jfn.CLIP_FUNCTIONS))
def test_clip_functions_match_jax(name):
    norms = np.array([0.0, 1e-13, 0.05, 0.3, 0.99, 1.0, 2.5, 40.0], np.float32)
    want = np.asarray(jfn.get_clip_fn(name)(jnp.asarray(norms), 0.3))
    got = tfn.get_clip_fn(name)(torch.from_numpy(norms), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        tfn.get_clip_fn("nope")


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)), ("warmup_linear", (0.1, 5, 20)), ("warmup_cosine", (0.1, 5, 20)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 4, 5, 6, 12, 20, 25):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6, err_msg=str(step))


def _meta(kind, path="x/w", bias=None):
    return TapMeta(kind=kind, T=3, D=4, p=5, s_shape=(2, 3, 5), s_dtype=torch.float32,
                   param_path=path, bias_path=bias, batch_size=2,
                   a_shape=(2, 3, 4), a_dtype=torch.float32)


def test_validate_coverage_reports_missing_and_rejects_duplicates():
    params = {"x": {"w": torch.zeros(1), "b": torch.zeros(1)}, "y": {"w": torch.zeros(1)}}
    meta = {"x/out": _meta("matmul", "x/w", "x/b")}
    assert tclip.validate_coverage(meta, params) == ["y/w"]
    assert tclip.validate_coverage(meta, params, frozen_prefixes=("y",)) == []
    meta["z/out"] = _meta("scale", "x/w")
    with pytest.raises(ValueError, match="duplicate"):
        tclip.validate_coverage(meta, params)


# the modes an earlier slice refused with NotImplementedError; each now
# builds its executor, and an unknown mode still raises
FORMERLY_LATER_MODES = {
    "vmap": tclip.VmapExecutor, "ghost_taps": tclip.TapsExecutor,
    "fastgradclip_taps": tclip.TapsExecutor, "mixed_ghost_taps": tclip.TapsExecutor,
    "bk_mixed_taps": tclip.TapsExecutor,
}


@pytest.mark.parametrize("mode", sorted(FORMERLY_LATER_MODES))
def test_every_jax_mode_builds_its_executor(mode):
    """Every JAX mode builds its executor, the five that came last included;
    only an unknown mode raises."""
    assert set(tclip.MODES) == set(jclip.MODES)
    fn = tclip.dp_value_and_clipped_grad(lambda *a: None, tclip.ClipConfig(mode=mode))
    assert type(fn) is FORMERLY_LATER_MODES[mode]
    with pytest.raises(ValueError, match="unknown clipping mode"):
        tclip.dp_value_and_clipped_grad(lambda *a: None, tclip.ClipConfig(mode="nope"))


@pytest.mark.parametrize("kind,slice_name", [("dw_conv", "LM"), ("scale_grouped", "LM")])
def test_later_tap_kinds_name_their_slice(kind, slice_name):
    """The two kinds an earlier slice refused, naming the recurrent LM slice
    that ports them, now norm, bank and contract as the JAX package's do:
    a depthwise conv's (B, T, k, d) window against its (B, T, d) cotangent,
    a grouped scale's (B, T, h * dh) input against its cotangent, with a
    bias on the conv."""
    from repro.core import ghost as jghost
    from repro.core.taps import TapMeta as JTapMeta

    b, t, k, d, h, dh = 2, 3, 4, 5, 5, 4
    rng = np.random.default_rng(3)
    if kind == "dw_conv":
        dims = dict(T=t, D=k, p=d, s_shape=(b, t, d), bias_path="x/b")
        a = rng.standard_normal((b, t, k, d)).astype(np.float32)
        g = rng.standard_normal((b, t, d)).astype(np.float32)
    else:
        dims = dict(T=t, D=dh, p=h, s_shape=(b, t, h * dh), bias_path=None)
        a = rng.standard_normal((b, t, h * dh)).astype(np.float32)
        g = rng.standard_normal((b, t, h * dh)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, b).astype(np.float32)
    common = dict(kind=kind, param_path="x/w", batch_size=b, a_shape=a.shape, **dims)
    tm = TapMeta(s_dtype=torch.float32, a_dtype=torch.float32, **common)
    jm = JTapMeta(s_dtype=jnp.float32, a_dtype=jnp.float32, **common)
    shape = tghost.psg_param_shape(tm)
    assert shape == jghost.psg_param_shape(jm), f"{kind} (ported with the {slice_name} slice)"
    ta, tg = torch.as_tensor(a), torch.as_tensor(g)
    for mode in ("mixed_ghost", "bk_mixed"):
        tbank = tghost.tap_bank(tm, ta, tg, mode=mode)
        jbank = jghost.tap_bank(jm, jnp.asarray(a), jnp.asarray(g), mode=mode)
        assert tbank.keys() == jbank.keys(), (mode, tbank.keys(), jbank.keys())
        for key, val in tbank.items():
            np.testing.assert_allclose(val.numpy(), np.asarray(jbank[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{kind} {mode} {key}")
    tw = tghost.tap_weighted_grads(tm, ta, tg, torch.as_tensor(c), shape)
    jw = jghost.tap_weighted_grads(jm, jnp.asarray(a), jnp.asarray(g), jnp.asarray(c), shape)
    assert tw.keys() == jw.keys()
    for path, val in tw.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jw[path]), rtol=1e-5, atol=1e-6)
