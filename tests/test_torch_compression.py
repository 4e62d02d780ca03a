"""bf16 gradient compression with error feedback
(``repro_torch.optim.compression``) against the JAX package's
``bf16_compress_with_error_feedback``: the same fp32 gradients (numpy, from
a seed, mixed magnitudes) through both for a few steps, the compressed
gradients and the residuals equal bit for bit (both round to nearest even
and subtract in fp32)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import bf16_compress_with_error_feedback as jcompress
from repro.optim.compression import init_error_feedback as jinit
from repro_torch.optim import bf16_compress_with_error_feedback, init_error_feedback
from repro_torch.utils.tree import flatten_dict
from torch_threads import torch_threads_per_worker  # noqa: F401


def _grads(rng, step):
    scale = 10.0 ** rng.integers(-6, 3, size=(3, 5))
    return {"a": {"w": (rng.standard_normal((3, 5)) * scale).astype(np.float32)},
            "b": (rng.standard_normal((7,)) * 1e-3 + step).astype(np.float32)}


def test_error_feedback_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    g0 = _grads(rng, 0)
    t_ef = init_error_feedback({"a": {"w": torch.zeros(3, 5)}, "b": torch.zeros(7)})
    j_ef = jinit({"a": {"w": jnp.zeros((3, 5))}, "b": jnp.zeros((7,))})
    assert all(torch.count_nonzero(v) == 0 and v.dtype == torch.float32
               for v in flatten_dict(t_ef).values())
    for step in range(4):
        g = g0 if step == 0 else _grads(rng, step)
        t_comp, t_ef = bf16_compress_with_error_feedback(
            {"a": {"w": torch.from_numpy(g["a"]["w"])}, "b": torch.from_numpy(g["b"])},
            t_ef if step else None)
        j_comp, j_ef = jcompress({"a": {"w": jnp.asarray(g["a"]["w"])}, "b": jnp.asarray(g["b"])},
                                 j_ef if step else None)
        for got, want in ((t_comp, j_comp), (t_ef, j_ef)):
            gf, wf = flatten_dict(got), flatten_dict(want)
            for k in wf:
                assert gf[k].dtype == torch.float32
                np.testing.assert_array_equal(gf[k].numpy(), np.asarray(wf[k]))
        # what compression dropped is carried, not lost
        for k, v in flatten_dict(t_comp).items():
            assert torch.equal(v, v.to(torch.bfloat16).float())
