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
from torch_threads import torch_threads_per_worker  # noqa: F401

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


def _embedding_metas(b, t, vocab, p, bf16=False):
    from repro.core.taps import TapMeta as JTapMeta
    from repro_torch.core.taps import TapMeta

    kw = dict(kind="embedding", T=t, D=vocab, p=p, s_shape=(b, t, p), param_path="emb/e",
              batch_size=b, a_shape=(b, t))
    return (JTapMeta(s_dtype=jnp.bfloat16 if bf16 else jnp.float32, a_dtype=jnp.int32, **kw),
            TapMeta(s_dtype=torch.bfloat16 if bf16 else torch.float32, a_dtype=torch.int64,
                    **kw))


def test_embedding_tap_with_repeated_ids_matches_jax():
    """An LM-like embedding tap (ids repeat within a sample): the per-sample
    norm and the book-keeping weighted gradient (a scatter-add of C_i g_i by
    id, the port's tap_weighted_grads of the book) against the JAX
    package's tap_norm_sq and bank_weighted_grads."""
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
    got = tghost.tap_weighted_grads(tmeta, bank["a"], bank["g"], torch.from_numpy(clip),
                                    (vocab, p))
    assert got.keys() == want.keys() == {"emb/e"}
    _close(got["emb/e"], want["emb/e"])


def test_embedding_tap_takes_a_bf16_cotangent_as_the_jax_package():
    """A bf16 cotangent reaches the port's embedding norm in its stored
    dtype (the plain version upcasts it tile by tile): the port's
    tap_norm_sq equals the JAX package's on the same bf16 values."""
    from repro.core import ghost as jghost
    from repro_torch.core import ghost as tghost

    b, t, vocab, p = 3, 24, 9, 16
    rng = np.random.default_rng(11)
    ids = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    g = torch.from_numpy(_np(rng, b, t, p)).to(torch.bfloat16)
    jmeta, tmeta = _embedding_metas(b, t, vocab, p, bf16=True)
    got = tghost.tap_norm_sq(tmeta, torch.from_numpy(ids).long(), g, mode="mixed_ghost")
    assert got.dtype == torch.float32
    want = jghost.tap_norm_sq(jmeta, jnp.asarray(ids), jnp.asarray(g.float().numpy(), jnp.bfloat16),
                              mode="mixed_ghost")
    _close(got, want, rtol=1e-5)


# ----------------------------- the card's embedding norm, emulated --
# csrc/embedding_norm.cu sorts each sample's positions by id and streams g's
# rows in that order: a warp sums 32 lanes x V columns (V = 16 bytes of g)
# over one range of sorted positions, squaring each segment's sum once it
# ends; a segment that crosses a range's end passes its partial vector on
# (the range's head or tail).  A block's 8 ranges fold in order into one
# unit; the finish sums a slice's units' inner sums 32 at a time and carries
# the crossing segments through the units in order; the slices sum in
# order.  This emulation follows that order in plain torch (fp32
# throughout) and predicts the card's reading against its 1e-4 gate.
_HEAD, _CLOSES, _TAIL = 1, 2, 4


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """The kernel's xor-butterfly sum over 32 lanes (every lane ends equal)."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[lanes ^ off]
    return x[0]


def _sq(c: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(c.shape[0])
    for v in range(c.shape[1]):
        s = s + c[:, v] * c[:, v]
    return s


def _range_unit(rows, start, k0, k1):
    """One warp's unit over sorted positions [k0, k1) of one slice: rows
    (T, 32, V) in sorted order, start (T,) the segment starts."""
    if k0 == k1:
        return None
    t = rows.shape[0]
    zero = torch.zeros(rows.shape[1:])
    acc, closed, head, tail = zero, torch.zeros(32), zero, zero
    in_head = not bool(start[k0])
    flags = _HEAD if in_head else 0
    for i in range(k0, k1):
        if i > k0 and bool(start[i]):
            if in_head:
                head, flags, in_head = acc, flags | _CLOSES, False
            else:
                closed = closed + _sq(acc)
            acc = zero
        acc = acc + rows[i]
    if in_head:
        head = acc
        flags |= _CLOSES if k1 == t or bool(start[k1]) else 0
    elif k1 == t or bool(start[k1]):
        closed = closed + _sq(acc)
    else:
        tail, flags = acc, flags | _TAIL
    return {"flags": flags, "inner": _warp_sum(closed), "head": head, "tail": tail}


def _fold(a, b, closed):
    """a followed by b, as the kernel's fold; returns (a, closed)."""
    if b is None:
        return a, closed
    if a is None:
        return dict(b), closed
    a = dict(a, inner=a["inner"] + b["inner"])
    if a["flags"] & _HEAD and not a["flags"] & _CLOSES:  # a is one open segment
        a.update(head=a["head"] + b["head"], tail=b["tail"],
                 flags=_HEAD | (b["flags"] & (_CLOSES | _TAIL)))
        return a, closed
    if b["flags"] & _HEAD:
        c = (a["tail"] if a["flags"] & _TAIL else torch.zeros_like(b["head"])) + b["head"]
        if not b["flags"] & _CLOSES:
            a.update(tail=c, flags=a["flags"] | _TAIL)
            return a, closed
        closed = closed + _sq(c)
    a.update(tail=b["tail"], flags=(a["flags"] & ~_TAIL) | (b["flags"] & _TAIL))
    return a, closed


SLOTS = 132 * 4  # the H100's SMs x the segment kernel's blocks an SM holds


def _emulate_embedding_kernel(ids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    n, t, p = g.shape
    vec = 16 // g.element_size()
    slices, blocks = tgn.embedding_plan(n, t, p, vec, SLOTS)
    warps = tgn.EMBED_WARPS
    splits = warps * blocks
    cols = torch.zeros(n, t, slices * 32 * vec)
    cols[:, :, :p] = g.float()
    cols = cols.view(n, t, slices, 32, vec)
    out = torch.zeros(n)
    for i in range(n):
        order = torch.sort(ids[i], stable=True).indices
        key = ids[i][order]
        start = torch.ones(t, dtype=torch.bool)
        start[1:] = key[1:] != key[:-1]
        rows = cols[i][order]
        warp_total = torch.zeros(32)
        for s in range(slices):
            block_units = []
            for b in range(blocks):
                a, closed = None, torch.zeros(32)
                for w in range(warps):
                    j = b * warps + w
                    unit = _range_unit(rows[:, s], start, j * t // splits, (j + 1) * t // splits)
                    a, closed = _fold(a, unit, closed)
                a["inner"] = a["inner"] + _warp_sum(closed)
                block_units.append(a)
            inner, closed, carry = torch.zeros(()), torch.zeros(32), torch.zeros(32, vec)
            for b0 in range(0, blocks, 32):
                chunk = block_units[b0:b0 + 32]
                lanes = torch.zeros(32)
                lanes[:len(chunk)] = torch.stack([u["inner"] for u in chunk])
                inner = inner + _warp_sum(lanes)
                for u in chunk:
                    if u["flags"] & _HEAD:
                        carry = carry + u["head"]
                        if u["flags"] & _CLOSES:
                            closed, carry = closed + _sq(carry), torch.zeros(32, vec)
                    if u["flags"] & _TAIL:
                        carry = u["tail"]
            assert not bool(carry.any())  # every segment closed inside [0, T)
            warp_total[s % 32] += inner + _warp_sum(closed)
        total = torch.zeros(())
        for w in range(32):
            total = total + warp_total[w]
        out[i] = total
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("all_equal", [False, True])
def test_embedding_sort_emulation_meets_the_gate(dtype, all_equal):
    """An LM-like tap with long segments (8 distinct ids over T = 2048, so
    every segment crosses many of the 256 ranges) and, in the second case,
    one sample whose ids are all equal: the kernel's order, emulated, within
    1e-4 of the JAX oracle and of the Pallas kernel (interpret mode)."""
    n, t, p = 2, 2048, 64
    rng = np.random.default_rng(17)
    ids = rng.integers(0, 8, size=(n, t)).astype(np.int32)
    if all_equal:
        ids[1] = 5
    g = torch.from_numpy(_np(rng, n, t, p)).to(dtype)
    slices, blocks = tgn.embedding_plan(n, t, p, 16 // g.element_size(), SLOTS)
    assert (slices, blocks) == (1, 32)  # 256 ranges of 8 positions a sample
    got = _emulate_embedding_kernel(torch.from_numpy(ids).long(), g)
    jids, jg = jnp.asarray(ids), jnp.asarray(g.float().numpy())
    _close(got, embedding_ghost_norm_sq_ref(jids, jg), rtol=1e-4)
    pallas = embedding_ghost_norm_sq_pallas(jids, jg, block_t=1024, block_f=64, interpret=True)
    _close(got, pallas, rtol=1e-4)


def test_embedding_plan_fills_the_card():
    """The segment pass's split: 16-byte lane slices of 32 lanes; the
    blocks fill the card's slots in one wave, every (sample, slice) alike,
    and cut no range under 8 positions; pure functions of the shape."""
    assert tgn.embedding_plan(32, 196, 768, 8, SLOTS) == (3, 3)  # ViT-Base: T caps it
    assert tgn.embedding_plan(4, 2048, 4096, 8, SLOTS) == (16, 8)
    assert tgn.embedding_plan(1, 8192, 4096, 8, SLOTS) == (16, 33)
    assert tgn.embedding_plan(2, 1, 10, 4, SLOTS) == (1, 1)
    assert tgn.embedding_plan(64, 512, 4096, 8, SLOTS) == (16, 1)  # more than a wave
    for n, t, p, vec in ((4, 2048, 4096, 8), (1, 8192, 4096, 8), (2, 40000, 8, 4)):
        slices, blocks = tgn.embedding_plan(n, t, p, vec, SLOTS)
        assert slices * 32 * vec >= p > (slices - 1) * 32 * vec
        assert t // (tgn.EMBED_WARPS * blocks) >= tgn.EMBED_MIN_ROWS
        assert SLOTS - n * slices <= n * slices * blocks <= SLOTS


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


# the segment lists of one grouped call, built as a bk_mixed step builds
# them: a reduced VGG's (a psg-banked conv's weight and bias, GroupNorm
# scales and biases) and a stacked 2-layer ViT's (each norm's scale and bias
# one segment per layer, then the final norm's); F = 1, 33 and 1000
GROUPED_LISTS = {
    "vgg_reduced": [1000, 33, 33, 33, 1, 1],
    "vit_2_layers": [33, 33, 33, 33, 1000, 1000, 1000, 1000, 33, 33],
}


@pytest.mark.parametrize("n", [1, 5, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(GROUPED_LISTS))
def test_psg_contract_grouped_plain_vs_jax_ref_and_pallas(kind, dtype, n):
    """The grouped plain version, segment by segment, against the JAX
    oracle and the interpreted Pallas kernel (one bank per call there)."""
    sizes = GROUPED_LISTS[kind]
    rng = np.random.default_rng(n + len(sizes))
    tdt = getattr(torch, dtype)
    psgs = [torch.from_numpy(_np(rng, n, f)).to(tdt) for f in sizes]
    c = rng.uniform(size=(n,)).astype(np.float32)
    got = tpc.psg_contract_grouped_plain(psgs, torch.from_numpy(c))
    assert got.dtype == torch.float32 and got.shape == (sum(sizes),)
    jc = jnp.asarray(c)
    for psg, part in zip(psgs, torch.split(got, sizes)):
        jpsg = jnp.asarray(psg.float().numpy()).astype(getattr(jnp, dtype))  # exact
        _close(part, psg_contract_ref(jpsg, jc))
        _close(part, psg_contract_pallas(jpsg, jc, block_n=16, block_f=128, interpret=True))


def test_dispatch_psg_contract_grouped_is_one_call():
    """One dispatched group is one count, and a one-bank group is
    dispatch.psg_contract; an empty group contracts nothing."""
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.uniform(size=(4,)).astype(np.float32))
    psgs = [torch.from_numpy(_np(rng, 4, *shape)) for shape in ((3, 2), (1,), (5,))]
    launches.reset()
    got = dispatch.psg_contract_grouped(psgs, c)
    assert launches.snapshot()["psg_contract"] == {"cuda": 0, "torch": 1, "fake": 0}
    want = torch.cat([torch.einsum("n...,n->...", x, c).reshape(-1) for x in psgs])
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(dispatch.psg_contract(psgs[0], c), want[:6].reshape(3, 2))
    assert tpc.psg_contract_grouped_plain([], c).shape == (0,)


@pytest.mark.parametrize("n_rows", [1, 2, 3])
def test_psg_contract_grouped_plain_with_factor_rows(n_rows):
    """A (G, N) factor matrix with one row index per bank, the rows
    interleaved across the banks: each bank's sum is its own einsum against
    its own row; one dispatched call, one count."""
    rng = np.random.default_rng(n_rows)
    sizes = GROUPED_LISTS["vit_2_layers"]
    psgs = [torch.from_numpy(_np(rng, 5, f)) for f in sizes]
    c = torch.from_numpy(rng.uniform(size=(n_rows, 5)).astype(np.float32))
    rows = [i % n_rows for i in range(len(psgs))]
    launches.reset()
    got = dispatch.psg_contract_grouped(psgs, c, rows)
    assert launches.snapshot()["psg_contract"] == {"cuda": 0, "torch": 1, "fake": 0}
    want = torch.cat([torch.einsum("nf,n->f", x, c[r]) for x, r in zip(psgs, rows)])
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(tpc.psg_contract_grouped_plain(psgs, c, rows), want)
    with pytest.raises(ValueError, match="one row index per bank"):
        tpc.psg_contract_grouped_plain(psgs, c)
    with pytest.raises(ValueError, match="c is \\(N,\\)"):
        tpc.psg_contract_grouped_plain(psgs, c[0], rows)


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
    assert snap["ghost_norm_sq"] == {"cuda": 0, "torch": 1, "fake": 0}
    assert snap["embedding_ghost_norm_sq"] == {"cuda": 0, "torch": 1, "fake": 0}
    assert snap["book_weighted_grad"] == {"cuda": 0, "torch": 1, "fake": 0}
    assert snap["psg_contract"] == {"cuda": 0, "torch": 2, "fake": 0}
    launches.reset()
    assert all(v == 0 for per in launches.snapshot().values() for v in per.values())


def test_ghost_tile_choice_follows_t():
    """The Gram kernels: T <= 16 in one packed m16 tile, else 64-row tiles."""
    assert tgn.tile_for(1) == 16 and tgn.tile_for(16) == 16
    assert tgn.tile_for(17) == 64 and tgn.tile_for(256) == 64


# ------------------------------------ the card's book kernel, emulated --
# csrc/book_weighted_grad.cu multiplies on the tensor cores, which take no
# fp32 operand: an fp32 value x is split into bf16 pieces and a tile product
# becomes a sum of low-precision products (an fp32 activation and the
# weighted cotangent three pieces each, six products; the weighted
# cotangent two pieces beside a bf16 activation, which is exact).  These
# tests emulate that rounding on the CPU at the main path's reduction
# length (VGG-19's R = 8192 taps) and predict the card's reading against
# the 1e-4 gate, and on a book whose sums one product dominates (a
# vocabulary head) the reading between two equivalent steps against the
# fp32 gates' 1e-5.
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


def _split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x = hi + mid + lo in bf16 (the kernel's three-piece split)."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def _emulate_book(a, g, w, *, kind="bf16", products=None):
    """The kernel's arithmetic for one m: g scaled by w in fp32 and split;
    per 32-row k-step the chain of MMAs (small terms first) summed exactly
    and rounded to fp32, added to an fp32 running sum; R cut as book_splits
    cuts it on a 132-SM card, the splits' sums added in split order.
    ``products`` None is the kernel: an fp32 a and w g in three bf16 pieces
    each, six products (bf16x6), a bf16 a exact beside w g in two pieces;
    3 is the two-piece split with a's lo g's lo dropped (bf16x3, the
    kernel's before the model axis's fp32 gates, or 3xTF32 with
    ``kind="tf32"``);
    1 one product of the rounded operands."""
    r, d = a.shape
    gw = g.float() * w[:, None]
    if products is None and kind == "bf16" and a.dtype != torch.bfloat16:
        (ah, am, al), (gh, gm, gl) = _split3(a.float()), _split3(gw)
        terms = [(am, gm), (al, gh), (ah, gl), (am, gh), (ah, gm), (ah, gh)]
    else:
        g_hi, g_lo = _split(gw, kind)
        if a.dtype == torch.bfloat16:
            a_hi, a_lo = a.float(), torch.zeros(r, d)
        else:
            a_hi, a_lo = _split(a, kind)
        terms = [(a_lo, g_hi), (a_hi, g_lo), (a_hi, g_hi)][3 - (products or 3):]
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
    """The kernel's split (bf16x6 for an fp32 activation, two products
    beside a bf16 one), or 3xTF32, at R = 8192 stays within a tenth of the
    card's 1e-4 gate."""
    a, g, w, exact = _book_inputs(8192, 130, 70, a_dtype, g_dtype)
    err = _rel_to_largest(_emulate_book(a, g, w, kind=kind), exact)
    assert err <= BOOK_GATE / 10, err


def test_book_fp32_split_holds_equivalent_steps_together():
    """Two equivalent fp32 steps (the model axis against one rank) hand the
    book inputs an ulp or two apart.  On a vocabulary head's book, where
    one product dominates each column's sum, the kernel's bf16x6 keeps the
    two contractions as far apart as the exact ones (and within 1e-6 of
    them), well under the fp32 gates' 1e-5; the two-piece bf16x3 moves
    each by up to ~1e-5 of the largest entry on its own (the card read
    1.15e-5 between the sharded and the one-rank Mixtral-8x7B head, on
    one H100)."""
    rng = np.random.default_rng(0)
    r, d, p = 256, 64, 8192
    a = torch.from_numpy(_np(rng, r, d))
    logits = torch.from_numpy(_np(rng, r, p))
    g = (torch.softmax(logits, -1) - torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, p, r)), p)) / r
    w = torch.from_numpy(rng.uniform(0.2, 1.0, r).astype(np.float32))
    a2 = a + a.abs() * 2.0**-22 * torch.from_numpy(_np(rng, r, d))
    g2 = g + g.abs() * 2.0**-23 * torch.from_numpy(_np(rng, r, p))
    exact = [x.double().T @ (y.double() * w.double()[:, None]) for x, y in ((a, g), (a2, g2))]
    apart = _rel_to_largest(exact[1].float(), exact[0])
    six = [_emulate_book(x, y, w) for x, y in ((a, g), (a2, g2))]
    assert _rel_to_largest(six[0], exact[0]) <= 1e-6
    assert _rel_to_largest(six[1], six[0].double()) <= apart + 1e-6 <= 2e-6
    three = [_emulate_book(x, y, w, products=3) for x, y in ((a, g), (a2, g2))]
    assert _rel_to_largest(three[1], three[0].double()) >= 4e-6


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


# ------------------------------ the card's ghost-norm kernels, emulated --
# csrc/ghost_norm.cu forms both Grams on the tensor cores: a bf16 operand
# is exact (one product), an fp32 one is split into bf16 hi + lo and its
# Gram is lo.hi + hi.lo + hi.hi.  Each k-step's MMA chain (32 features in
# the tiles kernel, T >= 17; 16 in the packed kernel, T <= 16, whose 8 warps
# take every 8th chunk and are summed in warp order) is rounded to fp32 and
# added to an fp32 running sum.  These tests emulate that arithmetic at the
# main paths' shapes and predict the card's reading against its 1e-4 gate.
GHOST_GATE = 1e-4  # chip_smoke.py TOL["ghost_norm_sq"], kernel vs plain


def _emulate_gram(x: torch.Tensor, products: int) -> torch.Tensor:
    """The kernel's Gram of one sample's (T, D) operand, fp32."""
    t, d = x.shape
    if x.dtype == torch.bfloat16:
        hi, lo = x.float(), torch.zeros(t, d)
    else:
        hi, lo = _split(x, "bf16")
    step, warps = (32, 1) if t > 16 else (16, 8)
    pad = (-d) % step
    hi, lo = _pad_features(hi, pad), _pad_features(lo, pad)
    terms = [(lo, hi), (hi, lo), (hi, hi)][3 - products:]
    n_steps = hi.shape[1] // step
    chains = sum(  # (steps, T, T): each k-step's chain, exact, then rounded
        torch.einsum("tsk,usk->stu", u.double().reshape(t, n_steps, step),
                     v.double().reshape(t, n_steps, step)) for u, v in terms
    ).float()
    per_warp = [torch.zeros(t, t) for _ in range(warps)]
    for s in range(n_steps):
        per_warp[s % warps] += chains[s]
    total = torch.zeros(t, t)
    for w in per_warp:
        total += w
    return total


def _pad_features(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _emulate_ghost_norm(a, g, products_fp32=3):
    """Per sample: both emulated Grams, their elementwise product summed in
    fp32 over 64-row tile pairs (off-diagonal pairs twice), pairs in order."""
    out = []
    for ai, gi in zip(a, g):
        ga = _emulate_gram(ai, 1 if ai.dtype == torch.bfloat16 else products_fp32)
        gg = _emulate_gram(gi, 1 if gi.dtype == torch.bfloat16 else products_fp32)
        prod, t = ga * gg, ai.shape[0]
        tile = tgn.tile_for(t)
        total = torch.zeros((), dtype=torch.float32)
        for i in range(0, t, tile):
            for j in range(0, i + 1, tile):
                w = 1.0 if i == j else 2.0
                total += w * prod[i:i + tile, j:j + tile].sum()
        out.append(total)
    return torch.stack(out)


def _ghost_inputs(n, t, d, p, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(_np(rng, n, t, d)).to(dtype)
    g = torch.from_numpy(_np(rng, n, t, p)).to(dtype)
    ad, gd = a.double(), g.double()
    exact = ((ad @ ad.mT) * (gd @ gd.mT)).sum(dim=(1, 2))
    return a, g, exact


# (N, T, D, p) and dtype of the main paths: VGG-19's conv taps at T = 64
# (the tiles kernel, one pair) and T = 4 (the packed kernel, 4 samples a
# tile), ViT-Base's MLP tap at T = 196 (4 x 4 tiles, 10 pairs) in bf16
GHOST_EMULATED = [((2, 64, 2304, 256), torch.float32), ((4, 4, 4608, 512), torch.float32),
                  ((2, 196, 3072, 768), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", GHOST_EMULATED)
def test_ghost_split_emulation_meets_the_gate(shape, dtype):
    """The kernel's arithmetic (bf16x3 for fp32, one exact product for bf16)
    at the main paths' shapes stays within a tenth of the 1e-4 gate."""
    a, g, exact = _ghost_inputs(*shape, dtype)
    err = _rel_to_largest(_emulate_ghost_norm(a, g), exact)
    print(f"ghost norm {shape} {dtype}: emulated reading {err:.2e} (gate {GHOST_GATE:.0e})")
    assert err <= GHOST_GATE / 10, err


# What one bf16 product of the rounded fp32 operands (hi.hi only) reads in
# this emulation: 4.85e-5 at T = 64 (under the gate, with half its margin
# gone) and 3.05e-4 at T = 4 (over it); bf16x3 reads 5.5e-6 at both.
GHOST_ONE_PRODUCT_MISSES = {(2, 64, 2304, 256): False, (4, 4, 4608, 512): True}


@pytest.mark.parametrize("shape", list(GHOST_ONE_PRODUCT_MISSES))
def test_ghost_single_bf16_product_reading(shape):
    """Negative control: one bf16 product of rounded fp32 operands.  Its
    reading is recorded; it is asserted to miss the gate only where it does."""
    a, g, exact = _ghost_inputs(*shape, torch.float32)
    one = _rel_to_largest(_emulate_ghost_norm(a, g, products_fp32=1), exact)
    split = _rel_to_largest(_emulate_ghost_norm(a, g), exact)
    print(f"ghost norm {shape}: one bf16 product reads {one:.2e}, bf16x3 {split:.2e}")
    assert (one > GHOST_GATE) == GHOST_ONE_PRODUCT_MISSES[shape], one
    assert one > split


# ------------------------------------------ the conv entry's patches --
def _conv_infos():
    from repro.core.taps import ConvInfo as JConvInfo
    from repro_torch.core.taps import ConvInfo

    def both(kernel, strides, padding):
        return (ConvInfo(kernel=kernel, strides=strides, padding=padding),
                JConvInfo(kernel=kernel, strides=strides, padding=padding))
    return both


# (N, H, W, C), kernel, strides, padding: SAME and VALID, stride 2 (XLA's
# (0, 1) padding), C not a multiple of 8, T = 1, a 1x1 kernel, explicit
# pads, and the ViT's 16x16 / 16 patch embedding on a 2x2 patch grid
CONV_CASES = [
    ((2, 6, 6, 16), (3, 3), (1, 1), "SAME"),
    ((2, 7, 5, 8), (3, 3), (1, 1), "VALID"),
    ((3, 8, 8, 5), (3, 3), (2, 2), "SAME"),
    ((2, 7, 7, 3), (3, 2), (2, 1), "SAME"),
    ((4, 3, 3, 12), (3, 3), (1, 1), "VALID"),  # T = 1
    ((2, 4, 4, 7), (1, 1), (1, 1), "SAME"),
    ((2, 5, 6, 4), (3, 3), (1, 2), ((2, 0), (1, 1))),
    ((2, 32, 32, 3), (16, 16), (16, 16), "VALID"),  # the ViT patch embedding
]


def _conv_patches_hwc(x: torch.Tensor, info) -> torch.Tensor:
    """The conv kernel's patches: (N, H, W, C) -> (N, H_out*W_out, kh*kw*C).

    Row t is output position (y, x) = (t // W_out, t % W_out) and feature k
    walks (i, j, c) with c fastest, element x[n, y*s_h + i - pad_top,
    x*s_w + j - pad_left, c], zero where that falls outside the image: the
    kernel's index arithmetic and masks, gathered in plain PyTorch.  The
    features are ``unfold2d``'s in another order, so the Gram is the same.
    """
    from repro_torch.nn.conv import conv_padding

    n, h, w, c = x.shape
    (kh, kw), (sh, sw) = info.kernel, info.strides
    (pt, pb), (pl, pr) = conv_padding(info.padding, (h, w), info.kernel, info.strides)
    h_out, w_out = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    t = torch.arange(h_out * w_out, device=x.device)
    k = torch.arange(kh * kw * c, device=x.device)
    y, xo = t // w_out, t % w_out
    i, j, ch = k // (kw * c), (k % (kw * c)) // c, k % c
    yy = y[:, None] * sh + i[None, :] - pt  # (T, D)
    xx = xo[:, None] * sw + j[None, :] - pl
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    flat = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)) * c + ch[None, :]
    vals = x.reshape(n, h * w * c)[:, flat.reshape(-1)].reshape(n, h_out * w_out, kh * kw * c)
    return vals * inside.to(x.dtype)


@pytest.mark.parametrize("shape,kernel,strides,padding", CONV_CASES)
def test_conv_patch_order_matches_unfold2d(shape, kernel, strides, padding):
    """The kernel's (i, j, c) patches with their padding masks hold
    unfold2d's channel-major patches in another feature order (exactly),
    so their Grams agree."""
    from repro_torch.core.taps import ConvInfo
    from repro_torch.nn.conv import unfold2d

    info = ConvInfo(kernel=kernel, strides=strides, padding=padding)
    x = torch.from_numpy(_np(np.random.default_rng(sum(shape)), *shape))
    hwc = _conv_patches_hwc(x, info)
    ref = unfold2d(x, info)
    assert hwc.shape == ref.shape
    c, (kh, kw) = shape[3], kernel
    # channel-major index c * kh * kw + i * kw + j -> (i * kw + j) * C + c
    perm = torch.arange(kh * kw * c).reshape(c, kh * kw).T.reshape(-1)
    assert torch.equal(hwc, ref[:, :, perm])
    torch.testing.assert_close(hwc @ hwc.mT, ref @ ref.mT, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,kernel,strides,padding", CONV_CASES)
def test_conv_ghost_norm_plain_vs_jax(shape, kernel, strides, padding):
    """conv_ghost_norm_sq's plain path (and the dispatched op on the CPU)
    against the JAX package's ghost norm of conv_general_dilated_patches."""
    from repro.nn.conv import unfold2d as junfold2d

    info, jinfo = _conv_infos()(kernel, strides, padding)
    rng = np.random.default_rng(sum(shape) + 1)
    x = _np(rng, *shape)
    t = _conv_patches_hwc(torch.from_numpy(x), info).shape[1]
    g = _np(rng, shape[0], t, 6)
    want = jgops.ghost_norm_sq(junfold2d(jnp.asarray(x), jinfo), jnp.asarray(g))
    got = tgops.conv_ghost_norm_sq(torch.from_numpy(x), torch.from_numpy(g), info)
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    _close(got, want)
    launches.reset()
    _close(dispatch.conv_ghost_norm_sq(torch.from_numpy(x), torch.from_numpy(g), info), want)
    assert launches.snapshot()["ghost_norm_sq"] == {"cuda": 0, "torch": 1, "fake": 0}


def test_conv_entry_refuses_a_cpu_tensor():
    """Forcing the kernel on CPU tensors raises; it never falls back."""
    from repro_torch.core.taps import ConvInfo

    info = ConvInfo(kernel=(3, 3), strides=(1, 1), padding="SAME")
    x, g = torch.zeros(2, 4, 4, 3), torch.zeros(2, 16, 5)
    with dispatch.force_impl("cuda"), pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.conv_ghost_norm_sq(x, g, info)


@pytest.mark.parametrize("conv", [False, True])
def test_tap_norm_takes_the_cotangent_in_its_dtype(conv):
    """tap_norm_sq hands a ghost tap's cotangent over in its stored dtype:
    a bf16 cotangent gives bit for bit the norm of its fp32 upcast (the
    JAX package's order: upcast first), the conv tap without unfolding."""
    from repro_torch.core import ghost as tghost
    from repro_torch.core.taps import ConvInfo, TapMeta

    rng = np.random.default_rng(7)
    b, p = 3, 6
    if conv:
        info = ConvInfo(kernel=(3, 3), strides=(1, 1), padding="SAME")
        a = torch.from_numpy(_np(rng, b, 2, 2, 8)).to(torch.bfloat16)
        t, d = 4, 72
    else:
        info = None
        a = torch.from_numpy(_np(rng, b, 4, 64)).to(torch.bfloat16)
        t, d = 4, 64
    g = torch.from_numpy(_np(rng, b, t, p)).to(torch.bfloat16)
    meta = TapMeta(kind="matmul", T=t, D=d, p=p, s_shape=(b, t, p), s_dtype=torch.bfloat16,
                   param_path="w", bias_path="b", conv=info, batch_size=b,
                   a_shape=tuple(a.shape), a_dtype=torch.bfloat16)
    assert tghost.decide(meta, mode="mixed_ghost") == "ghost"
    got = tghost.tap_norm_sq(meta, a, g, mode="mixed_ghost")
    assert got.dtype == torch.float32
    assert torch.equal(got, tghost.tap_norm_sq(meta, a, g.float(), mode="mixed_ghost"))
