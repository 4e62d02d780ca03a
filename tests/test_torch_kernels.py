"""The port's plain kernel versions and dispatch, held against the JAX
package's oracles (``kernels/*/ref.py``) and Pallas kernels (interpret mode),
on the same numpy inputs.  The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ghost_norm import ops as jgops
from repro.kernels.ghost_norm.ghost_norm import (
    embedding_ghost_norm_sq_pallas,
    ghost_norm_sq_pallas,
)
from repro.kernels.ghost_norm.ref import (
    embedding_ghost_norm_sq_ref,
    ghost_norm_sq_ref,
    instantiated_norm_sq_ref,
)
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


# ---------------------------------------------- embedding ghost norm --
@pytest.mark.parametrize("n,t,vocab,p,block", [
    (3, 12, 11, 5, 1024),  # direct path, repeated ids
    (3, 300, 11, 5, 128),  # ragged T (300 = 2 * 128 + 44): the tiled path
    (2, 25, 25, 8, 16),  # the ViT's position ids: all distinct, T off the tile
    (4, 1, 3, 7, 16),  # T = 1
])
def test_embedding_ghost_norm_plain_vs_jax(n, t, vocab, p, block):
    rng = np.random.default_rng(t + vocab)
    if vocab == t:
        ids = np.broadcast_to(np.arange(t, dtype=np.int32), (n, t)).copy()
    else:
        ids = rng.integers(0, vocab, size=(n, t)).astype(np.int32)
    g = _np(rng, n, t, p)
    got = tgops.embedding_ghost_norm_sq(torch.from_numpy(ids), torch.from_numpy(g), block=block)
    assert got.dtype == torch.float32
    jids, jg = jnp.asarray(ids), jnp.asarray(g)
    _close(got, embedding_ghost_norm_sq_ref(jids, jg), rtol=1e-4 if t > 256 else RTOL)
    _close(got, jgops.embedding_ghost_norm_sq(jids, jg, block=block),
           rtol=1e-4 if t > 256 else RTOL)
    # the dispatched op takes int64 ids as well
    got64 = dispatch.embedding_ghost_norm_sq(torch.from_numpy(ids).long(), torch.from_numpy(g))
    _close(got64, embedding_ghost_norm_sq_ref(jids, jg), rtol=1e-4 if t > 256 else RTOL)


@pytest.mark.parametrize("t", [37, 41])
def test_embedding_ghost_norm_plain_vs_pallas(t):
    """Odd T forces the Pallas kernel's padded path, sentinels included."""
    rng = np.random.default_rng(t)
    ids = rng.integers(0, 7, size=(3, t)).astype(np.int32)
    g = _np(rng, 3, t, 5)
    got = tgn.embedding_ghost_norm_sq_plain(torch.from_numpy(ids), torch.from_numpy(g))
    pallas = embedding_ghost_norm_sq_pallas(
        jnp.asarray(ids), jnp.asarray(g), block_t=16, block_f=8, interpret=True
    )
    _close(got, pallas, rtol=2e-5)


def test_embedding_pad_sentinels_never_match():
    """The two id operands are padded with different sentinels (-1 / -2):
    no padded position of either matches any position of the other, so the
    tiled sum never depends on how g is padded (as the JAX package pins)."""
    t, block = 37, 16
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 50, size=(2, t)))
    ids_i, ids_j = tgops.pad_ids_pair(ids, block)
    assert ids_i.shape == ids_j.shape == (2, 48)
    assert not bool((ids_i[:, t:, None] == ids_j[:, None, :]).any())
    assert not bool((ids_j[:, t:, None] == ids_i[:, None, :]).any())
    assert torch.equal(ids_i[:, :t], ids) and torch.equal(ids_j[:, :t], ids)
    assert set(ids_i[:, t:].unique().tolist()) == {-1}
    assert set(ids_j[:, t:].unique().tolist()) == {-2}
    even_i, even_j = tgops.pad_ids_pair(ids_i[:, :32], block)
    assert even_i is even_j and even_i.shape == (2, 32)
    jids_i, jids_j = jgops.pad_ids_pair(jnp.asarray(ids.numpy()), block)
    np.testing.assert_array_equal(ids_i.numpy(), np.asarray(jids_i))
    np.testing.assert_array_equal(ids_j.numpy(), np.asarray(jids_j))
    g = torch.from_numpy(_np(rng, 2, t, 5))
    got = tgops.embedding_ghost_norm_sq(ids, g, block=block)
    _close(got, embedding_ghost_norm_sq_ref(jnp.asarray(ids.numpy()), jnp.asarray(g.numpy())),
           rtol=1e-4)


def _embedding_metas(b, t, vocab, p):
    from repro.core.taps import TapMeta as JTapMeta
    from repro_torch.core.taps import TapMeta

    kw = dict(kind="embedding", T=t, D=vocab, p=p, s_shape=(b, t, p), param_path="emb/e",
              batch_size=b, a_shape=(b, t))
    return (JTapMeta(s_dtype=jnp.float32, a_dtype=jnp.int32, **kw),
            TapMeta(s_dtype=torch.float32, a_dtype=torch.int64, **kw))


def test_embedding_tap_with_repeated_ids_matches_jax():
    """An LM-like embedding tap (ids repeat within a sample): the per-sample
    norm and the book-keeping weighted gradient (a scatter-add of C_i g_i by
    id) against the JAX package's tap_norm_sq and bank_weighted_grads."""
    from repro.core import ghost as jghost
    from repro_torch.core import ghost as tghost

    b, t, vocab, p = 3, 10, 7, 5
    rng = np.random.default_rng(5)
    ids = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    assert len(np.unique(ids[0])) < t
    g = _np(rng, b, t, p)
    clip = rng.uniform(size=(b,)).astype(np.float32)
    jmeta, tmeta = _embedding_metas(b, t, vocab, p)
    jids, jg = jnp.asarray(ids), jnp.asarray(g)
    tids, tg = torch.from_numpy(ids).long(), torch.from_numpy(g)
    want_n = jghost.tap_norm_sq(jmeta, jids, jg, mode="mixed_ghost")
    _close(tghost.tap_norm_sq(tmeta, tids, tg, mode="mixed_ghost"), want_n)
    bank = tghost.tap_bank(tmeta, tids, tg, mode="bk_mixed")
    assert set(bank) == {"a", "g", "n"} and bank["a"].dtype == torch.int64
    _close(bank["n"], want_n)
    # the per-sample norm is the Frobenius norm of the scattered gradient
    dense = np.zeros((b, vocab, p), np.float32)
    for i in range(b):
        np.add.at(dense[i], ids[i], g[i])
    _close(bank["n"], (dense**2).sum(axis=(1, 2)))
    want = jghost.bank_weighted_grads(jmeta, {"a": jids, "g": jg}, jnp.asarray(clip), (vocab, p))
    got = tghost.bank_weighted_grads(tmeta, bank, torch.from_numpy(clip), (vocab, p))
    assert got.keys() == want.keys() == {"emb/e"}
    _close(got["emb/e"], want["emb/e"])


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
    assert dispatch.resolve("embedding_ghost_norm", cpu) == "torch"
    assert dispatch.resolve("flash_attention", cpu) == "torch"
    with dispatch.force_impl("cuda"):
        assert dispatch.resolve("ghost_norm", cpu) == "cuda"
        assert dispatch.resolve("embedding_ghost_norm", cpu) == "cuda"
        with dispatch.force_impl(ghost_norm="torch"):
            assert dispatch.resolve("ghost_norm", cpu) == "torch"
            assert dispatch.resolve("psg_contract", cpu) == "cuda"
        assert dispatch.resolve("ghost_norm", cpu) == "cuda"
    assert dispatch.resolve("ghost_norm", cpu) == "torch"
    assert dispatch.resolve("ghost_norm", cpu, impl="cuda") == "cuda"
    with pytest.raises(ValueError):
        dispatch.resolve("paged_attention", cpu)
    with pytest.raises(ValueError):
        dispatch.resolve("ghost_norm", cpu, impl="pallas")
    with pytest.raises(ValueError), dispatch.force_impl(nope="torch"):
        pass


def test_cpu_tensor_never_reaches_a_kernel_silently():
    """Forcing the kernel on a CPU tensor raises; it never falls back."""
    a, g = torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)
    with dispatch.force_impl("cuda"), pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.ghost_norm_sq(a, g)
    with dispatch.force_impl("cuda"), pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.embedding_ghost_norm_sq(torch.zeros(2, 3, dtype=torch.long), g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpc.book_weighted_grad_cuda(a, g, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpc.psg_contract_cuda(torch.zeros(2, 3), torch.zeros(2))


def test_launch_counts_per_impl():
    launches.reset()
    a, g = torch.ones(2, 3, 4), torch.ones(2, 3, 5)
    dispatch.ghost_norm_sq(a, g)
    dispatch.embedding_ghost_norm_sq(torch.zeros(2, 3, dtype=torch.long), g)
    dispatch.book_weighted_grad(a, g, torch.ones(2, 3))
    dispatch.psg_contract(torch.ones(4, 6), torch.ones(4))
    dispatch.psg_contract(torch.ones(4, 6), torch.ones(4))
    snap = launches.snapshot()
    assert snap["ghost_norm_sq"] == {"cuda": 0, "torch": 1}
    assert snap["embedding_ghost_norm_sq"] == {"cuda": 0, "torch": 1}
    assert snap["book_weighted_grad"] == {"cuda": 0, "torch": 1}
    assert snap["psg_contract"] == {"cuda": 0, "torch": 2}
    launches.reset()
    assert all(v == 0 for per in launches.snapshot().values() for v in per.values())


def test_ghost_tile_choice_follows_t():
    assert tgn.tile_for(1) == 16 and tgn.tile_for(16) == 16
    assert tgn.tile_for(17) == 32 and tgn.tile_for(256) == 32


# ------------------------------------ the card's book kernel, emulated --
# csrc/book_weighted_grad.cu multiplies on the tensor cores, which take no
# fp32 operand: each fp32 value x is split into x_hi + x_lo and a tile
# product becomes a sum of low-precision products.  These tests emulate that
# rounding on the CPU at the main path's reduction length (VGG-19's R =
# 8192 taps) and predict the card's reading against the 1e-4 gate.
def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round an fp32 tensor's mantissa to TF32's 10 bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _bf16(x) if kind == "bf16" else _tf32(x)
    lo = _bf16(x - hi) if kind == "bf16" else _tf32(x - hi)
    return hi, lo


def _emulate_book(a, g, w, *, kind="bf16", products=3):
    """The kernel's arithmetic for one m: g scaled by w in fp32 and split,
    a split unless it is bf16 (then exact); per 32-row k-step the chain of
    ``products`` MMAs (small terms first) summed exactly and rounded to
    fp32, added to an fp32 running sum; R cut as book_splits cuts it on a
    132-SM card, the splits' sums added in split order."""
    r, d = a.shape
    gw = g.float() * w[:, None]
    g_hi, g_lo = _split(gw, kind)
    if a.dtype == torch.bfloat16:
        a_hi, a_lo = a.float(), torch.zeros(r, d)
    else:
        a_hi, a_lo = _split(a, kind)
    terms = [(a_lo, g_hi), (a_hi, g_lo), (a_hi, g_hi)][3 - products:]
    splits, rows = tpc.book_splits(1, r, d, g.shape[1], 132)
    total = torch.zeros(d, g.shape[1])
    for s in range(splits):
        acc = torch.zeros(d, g.shape[1])
        for r0 in range(s * rows, min(r, (s + 1) * rows), tpc.BOOK_STEP):
            sl = slice(r0, min(r, r0 + tpc.BOOK_STEP, (s + 1) * rows))
            chain = sum(x[sl].double().T @ y[sl].double() for x, y in terms)
            acc += chain.float()
        total += acc
    return total


def _book_inputs(r, d, p, a_dtype, g_dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(_np(rng, r, d)).to(a_dtype)
    g = torch.from_numpy(_np(rng, r, p)).to(g_dtype)
    w = torch.from_numpy(rng.uniform(size=(r,)).astype(np.float32))
    exact = a.double().T @ (g.double() * w.double()[:, None])
    return a, g, w, exact


def _rel_to_largest(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


BOOK_GATE = 1e-4  # chip_smoke.py TOL["book_weighted_grad"], kernel vs plain


@pytest.mark.parametrize("kind", ["bf16", "tf32"])
@pytest.mark.parametrize("a_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
])
def test_book_split_emulation_meets_the_gate_at_r8192(a_dtype, g_dtype, kind):
    """The 3-product split (bf16x3, as the kernel does it, or 3xTF32) at
    R = 8192 stays within a tenth of the card's 1e-4 gate."""
    a, g, w, exact = _book_inputs(8192, 130, 70, a_dtype, g_dtype)
    err = _rel_to_largest(_emulate_book(a, g, w, kind=kind), exact)
    assert err <= BOOK_GATE / 10, err


def test_book_single_bf16_product_misses_the_gate():
    """Negative control: one bf16 product of the rounded fp32 operands (no
    split) exceeds the 1e-4 gate at R = 8192, so the split is needed."""
    a, g, w, exact = _book_inputs(8192, 130, 70, torch.float32, torch.float32)
    err = _rel_to_largest(_emulate_book(a, g, w, products=1), exact)
    assert err > BOOK_GATE, err


def test_book_splits_are_a_pure_function_of_the_shape():
    """The split of R depends on (M, R, D, p, SM count) alone; chunks are
    whole k-steps, cover R and leave no split empty; the grid fills the
    card's SMs twice over where R allows."""
    for m, r, d, p in [(1, 8192, 1152, 256), (1, 8192, 2304, 256), (1, 2048, 4608, 512),
                       (1, 512, 4608, 512), (1, 128, 512, 10), (12, 6272, 768, 3072),
                       (1, 1, 5, 3), (1, 8192, 130, 70), (3, 37, 33, 130)]:
        splits, rows = tpc.book_splits(m, r, d, p, 132)
        assert (splits, rows) == tpc.book_splits(m, r, d, p, 132)
        assert rows % tpc.BOOK_STEP == 0 and (splits - 1) * rows < r <= splits * rows
        tiles = m * -(-d // 128) * -(-p // 128)
        if splits > 1:
            assert rows >= tpc.MIN_ROWS_PER_SPLIT and tiles < 2 * 132
    assert tpc.book_splits(1, 8192, 1152, 256, 132) == (15, 576)
    assert tpc.book_splits(12, 6272, 768, 3072, 132) == (1, 6272)
