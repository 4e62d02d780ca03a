"""The port's plain kernel versions and dispatch, held against the JAX
package's oracles (``kernels/*/ref.py``) and Pallas kernels (interpret mode),
on the same numpy inputs.  The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ghost_norm import ops as jgops
from repro.kernels.ghost_norm.ghost_norm import ghost_norm_sq_pallas
from repro.kernels.ghost_norm.ref import ghost_norm_sq_ref, instantiated_norm_sq_ref
from repro.kernels.psg_contract.psg_contract import (
    book_weighted_grad_pallas,
    psg_contract_pallas,
)
from repro.kernels.psg_contract.ref import book_weighted_grad_ref, psg_contract_ref
from repro_torch.kernels import dispatch, launches
from repro_torch.kernels.ghost_norm import ghost_norm as tgn
from repro_torch.kernels.ghost_norm import ops as tgops
from repro_torch.kernels.psg_contract import psg_contract as tpc

RTOL = 1e-5  # fp32, same inputs; only the summation order differs


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().cpu().numpy()
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (err, scale)


# T = 1, ragged T (not a multiple of 16 or 32), D and p off any tile
GHOST_SHAPES = [
    (3, 64, 16, 24),
    (2, 100, 33, 7),
    (4, 1, 512, 10),
    (5, 37, 130, 9),
    (2, 4, 70, 5),
    (1, 17, 8, 130),
]


@pytest.mark.parametrize("n,t,d,p", GHOST_SHAPES)
def test_ghost_norm_plain_vs_jax_ref_and_pallas(n, t, d, p):
    rng = np.random.default_rng(t * 7 + d)
    a, g = _np(rng, n, t, d), _np(rng, n, t, p)
    got = tgn.ghost_norm_sq_plain(torch.from_numpy(a), torch.from_numpy(g))
    _close(got, ghost_norm_sq_ref(jnp.asarray(a), jnp.asarray(g)))
    pallas = ghost_norm_sq_pallas(
        jnp.asarray(a), jnp.asarray(g), block_t=16, block_f=32, interpret=True
    )
    _close(got, pallas, rtol=2e-5)


def test_ghost_norm_plain_tile_loop_vs_jax_scan():
    """T past the direct threshold forces both packages' tile loops.

    Each norm sums 1.2M signed fp32 terms in tiles of a different order, so
    this case gets the 1e-4 of the JAX package's own forced-scan test.
    """
    rng = np.random.default_rng(0)
    a, g = _np(rng, 2, 1100, 6), _np(rng, 2, 1100, 4)
    got = tgops.ghost_norm_sq(torch.from_numpy(a), torch.from_numpy(g), block=256)
    _close(got, jgops.ghost_norm_sq(jnp.asarray(a), jnp.asarray(g), block=256), rtol=1e-4)
    _close(got, ghost_norm_sq_ref(jnp.asarray(a), jnp.asarray(g)), rtol=1e-4)


def test_ghost_norm_plain_bf16_inputs_accumulate_fp32():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_np(rng, 2, 40, 24)).to(torch.bfloat16)
    g = torch.from_numpy(_np(rng, 2, 40, 12)).to(torch.bfloat16)
    got = tgn.ghost_norm_sq_plain(a, g)
    assert got.dtype == torch.float32
    want = ghost_norm_sq_ref(jnp.asarray(a.float().numpy()), jnp.asarray(g.float().numpy()))
    _close(got, want)


@pytest.mark.parametrize("d_block", [8, 64])
def test_instantiated_norm_vs_jax_ref(d_block):
    rng = np.random.default_rng(d_block)
    a, g = _np(rng, 3, 20, 50), _np(rng, 3, 20, 6)
    got = tgops.instantiated_norm_sq(torch.from_numpy(a), torch.from_numpy(g), block_d=d_block)
    _close(got, instantiated_norm_sq_ref(jnp.asarray(a), jnp.asarray(g)))


BOOK_SHAPES = [
    (1, 64, 16, 24),
    (2, 100, 33, 7),
    (3, 37, 8, 130),
    (1, 1, 512, 10),
]


@pytest.mark.parametrize("m,r,d,p", BOOK_SHAPES)
def test_book_weighted_grad_plain_vs_jax_ref_and_pallas(m, r, d, p):
    rng = np.random.default_rng(r * 3 + d)
    a, g = _np(rng, m, r, d), _np(rng, m, r, p)
    w = rng.uniform(size=(m, r)).astype(np.float32)
    got = tpc.book_weighted_grad_plain(*(torch.from_numpy(x) for x in (a, g, w)))
    assert got.shape == (m, d, p) and got.dtype == torch.float32
    _close(got, book_weighted_grad_ref(jnp.asarray(a), jnp.asarray(g), jnp.asarray(w)))
    pallas = book_weighted_grad_pallas(
        jnp.asarray(a), jnp.asarray(g), jnp.asarray(w),
        block_r=32, block_d=16, block_p=16, interpret=True,
    )
    _close(got, pallas, rtol=2e-5)


@pytest.mark.parametrize("n,f", [(5, 33), (64, 7), (3, 1024), (1, 1)])
def test_psg_contract_plain_vs_jax_ref_and_pallas(n, f):
    rng = np.random.default_rng(n + f)
    psg = _np(rng, n, f)
    c = rng.uniform(size=(n,)).astype(np.float32)
    got = tpc.psg_contract_plain(torch.from_numpy(psg), torch.from_numpy(c))
    _close(got, psg_contract_ref(jnp.asarray(psg), jnp.asarray(c)))
    pallas = psg_contract_pallas(
        jnp.asarray(psg), jnp.asarray(c), block_n=16, block_f=16, interpret=True
    )
    _close(got, pallas)


def test_dispatch_psg_contract_axis():
    """The result drops the sample axis and keeps the other dims in order."""
    rng = np.random.default_rng(0)
    psg = torch.from_numpy(_np(rng, 3, 5, 4, 2))
    c = torch.from_numpy(rng.uniform(size=(5,)).astype(np.float32))
    got = dispatch.psg_contract(psg, c, axis=1)
    assert got.shape == (3, 4, 2)
    torch.testing.assert_close(got, torch.einsum("lb...,b->l...", psg, c))


def test_dispatch_resolution_and_force_impl():
    cpu = torch.zeros(1)
    assert dispatch.default_impl("ghost_norm", cpu) == "torch"
    assert dispatch.resolve("psg_contract", cpu) == "torch"
    with dispatch.force_impl("cuda"):
        assert dispatch.resolve("ghost_norm", cpu) == "cuda"
        with dispatch.force_impl(ghost_norm="torch"):
            assert dispatch.resolve("ghost_norm", cpu) == "torch"
            assert dispatch.resolve("psg_contract", cpu) == "cuda"
        assert dispatch.resolve("ghost_norm", cpu) == "cuda"
    assert dispatch.resolve("ghost_norm", cpu) == "torch"
    assert dispatch.resolve("ghost_norm", cpu, impl="cuda") == "cuda"
    with pytest.raises(ValueError):
        dispatch.resolve("flash_attention", cpu)
    with pytest.raises(ValueError):
        dispatch.resolve("ghost_norm", cpu, impl="pallas")
    with pytest.raises(ValueError), dispatch.force_impl(nope="torch"):
        pass


def test_cpu_tensor_never_reaches_a_kernel_silently():
    """Forcing the kernel on a CPU tensor raises; it never falls back."""
    a, g = torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)
    with dispatch.force_impl("cuda"), pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.ghost_norm_sq(a, g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpc.book_weighted_grad_cuda(a, g, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpc.psg_contract_cuda(torch.zeros(2, 3), torch.zeros(2))


def test_launch_counts_per_impl():
    launches.reset()
    a, g = torch.ones(2, 3, 4), torch.ones(2, 3, 5)
    dispatch.ghost_norm_sq(a, g)
    dispatch.book_weighted_grad(a, g, torch.ones(2, 3))
    dispatch.psg_contract(torch.ones(4, 6), torch.ones(4))
    dispatch.psg_contract(torch.ones(4, 6), torch.ones(4))
    snap = launches.snapshot()
    assert snap["ghost_norm_sq"] == {"cuda": 0, "torch": 1}
    assert snap["book_weighted_grad"] == {"cuda": 0, "torch": 1}
    assert snap["psg_contract"] == {"cuda": 0, "torch": 2}
    launches.reset()
    assert all(v == 0 for per in launches.snapshot().values() for v in per.values())


def test_ghost_tile_choice_follows_t():
    assert tgn.tile_for(1) == 16 and tgn.tile_for(16) == 16
    assert tgn.tile_for(17) == 32 and tgn.tile_for(256) == 32
