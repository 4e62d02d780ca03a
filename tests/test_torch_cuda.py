"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs with the repository's conftest left out:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import dispatch, launches
from repro_torch.kernels.ghost_norm import ghost_norm as gn
from repro_torch.kernels.psg_contract import psg_contract as pc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,d,p", [(3, 37, 33, 7), (2, 1, 512, 10), (4, 100, 130, 70),
                                     (8, 16, 300, 40), (2, 256, 64, 32)])
def test_ghost_norm_kernel(gen, n, t, d, p, dtype):
    a, g = _rnd(gen, n, t, d, dtype=dtype), _rnd(gen, n, t, p, dtype=dtype)
    got = gn.ghost_norm_sq_cuda(a, g)
    assert _rel(got, gn.ghost_norm_sq_plain(a, g)) < 1e-4
    assert torch.equal(got, gn.ghost_norm_sq_cuda(a, g))  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,r,d,p", [(3, 37, 33, 130), (1, 1, 5, 3), (2, 1000, 70, 9)])
def test_book_weighted_grad_kernel(gen, m, r, d, p, dtype):
    a, g = _rnd(gen, m, r, d, dtype=dtype), _rnd(gen, m, r, p, dtype=dtype)
    w = torch.rand(m, r, generator=gen, device="cuda")
    got = pc.book_weighted_grad_cuda(a, g, w)
    assert _rel(got, pc.book_weighted_grad_plain(a, g, w)) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,f", [(5, 33), (1, 1), (130, 2049)])
def test_psg_contract_kernel(gen, n, f, dtype):
    psg = _rnd(gen, n, f, dtype=dtype)
    c = torch.rand(n, generator=gen, device="cuda")
    got = pc.psg_contract_cuda(psg, c)
    assert _rel(got, pc.psg_contract_plain(psg, c)) < 1e-5


def test_cuda_tensors_dispatch_to_kernels(gen):
    a, g = _rnd(gen, 2, 5, 4), _rnd(gen, 2, 5, 3)
    launches.reset()
    dispatch.ghost_norm_sq(a, g)
    dispatch.book_weighted_grad(a, g, torch.ones(2, 5, device="cuda"))
    dispatch.psg_contract(_rnd(gen, 4, 6), torch.ones(4, device="cuda"))
    snap = launches.snapshot()
    assert all(v == {"cuda": 1, "torch": 0} for v in snap.values()), snap
    with pytest.raises(ValueError, match="contiguous"):
        gn.ghost_norm_sq_cuda(a.transpose(0, 1), g.transpose(0, 1))
    with pytest.raises(ValueError, match="dtype"):
        gn.ghost_norm_sq_cuda(a, g.to(torch.bfloat16))
