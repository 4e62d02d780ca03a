"""DP training of the hybrid LM (Jamba) in the port, held against the JAX
package in all ten clipping modes.

``jamba-1.5-large-398b`` at its ``.reduced()`` size (one period of 8
layers: Mamba, and attention at index 3; MoE on every other layer with 4
experts; d_model 64, SSM heads of 8 with d_state 8, chunk 8, vocab 128),
the same numpy parameters (``repro_torch.interop``) and batch (2 samples of
32 tokens, some labels -100) in both packages on the CPU: the loss, the
per-sample norms and the clipped sums within 1e-5, fp32.  The JAX
package's ``*_taps`` reference runs with ``remat=False`` (its explicit
engine cannot trace its own checkpointed head), as in
``tests/test_torch_lm_train.py``.

Moved unchanged out of ``tests/test_torch_hybrid_train.py`` (whose
``_pair`` and ``_batch`` it uses): at 24-43 s a mode it is the slowest
case there, and a file of its own lets the test workers (one file each)
run it beside the rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import clipping as jclip
from repro_torch import interop
from repro_torch.core import clipping as tclip
from repro_torch.utils.tree import flatten_dict
from test_torch_hybrid_train import TOL, _batch, _pair


@pytest.mark.parametrize("mode", tclip.MODES)
def test_jamba_clipped_step_matches_jax(mode):
    jmodel, jmodel_noremat, tmodel, np_params = _pair("jamba-1.5-large-398b")
    batch = _batch(1)
    jm = jmodel_noremat if mode.endswith("_taps") else jmodel
    cfg = dict(mode=mode, clip_norm=0.3)
    jloss, jg, jaux = jax.jit(jclip.dp_value_and_clipped_grad(
        jm.loss_with_ctx, jclip.ClipConfig(**cfg)))(
        jax.tree_util.tree_map(jnp.asarray, np_params), batch)
    tparams = interop.params_from_jax(np_params, tmodel.conv_weights, device="cpu")
    tloss, tg, taux = tclip.dp_value_and_clipped_grad(
        tmodel.loss_with_ctx, tclip.ClipConfig(**cfg))(
        tparams, interop.batch_from_numpy(batch, device="cpu"))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    jn, tn = np.asarray(jaux["per_sample_norms"]), taux["per_sample_norms"].numpy()
    assert tn.shape == jn.shape == (2,)
    if mode != "non_private":  # C_i = 1 there: no norms
        assert float(np.abs(tn - jn).max()) <= TOL * float(np.abs(jn).max()), (tn, jn)
    jflat = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dict(interop.grads_to_jax_layout(tg, ()))
    assert tflat.keys() == jflat.keys()
    scale = max(float(np.abs(v).max()) for v in jflat.values())
    err = max(float(np.abs(tflat[p] - w).max()) for p, w in jflat.items())
    assert err <= TOL * scale, err / scale
