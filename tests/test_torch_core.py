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
    a, g = torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)
    for mode in ("mixed_ghost", "bk_mixed"):
        with pytest.raises(NotImplementedError, match=slice_name):
            tghost.tap_bank(_meta(kind), a, g, mode=mode)
