"""The port's plain attention forward, held against the JAX package.

``repro_torch.kernels.flash_attention.ops.flash_attention`` is the plain
version of the CUDA kernel (``csrc/flash_attention.cu``), which the card
tests hold to it.  Here, on the CPU, it meets the JAX package's oracle
(``ref.mha_reference``) and the Pallas kernel it replaces
(``flash_attention_pallas`` in interpret mode) at the cases of
``tests/test_kernels.py::test_flash_pallas_vs_ref``, plus grouped KV heads
and a window, and head dim 96 (Phi-3-vision) causal and at a
cross-attention shape (Sq != Skv, no mask), within the JAX tests' own
tolerances (2e-5 fp32, 5e-3 bf16).  Against the Pallas kernel a bf16 output may also differ by one bf16
step of the output (``rtol`` 2^-7): the kernel rounds P to bf16 before P.V
(``flash_attention.py:110``) where the plain version and the oracle keep it
in fp32, and both outputs are rounded to bf16.  The serving form (per-lane
``kv_positions`` and ``q_offset``) meets the JAX XLA path run once per lane.

The training attention (``flash_attention_train``, the blocked attention
with its own backward) meets the JAX ``flash_attention`` and its custom VJP:
outputs and the gradients of q, k and v for one random cotangent, causal,
windowed (window < S), GQA and MHA, S off the block (padded, padded keys
masked) and blocks of one tile, within 2e-5 of the largest entry in fp32
(cross-attention's Sq != Skv through the module: ``test_torch_encdec.py``);
under ``torch.func.vmap`` of ``grad`` it equals the per-sample calls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfops
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels import dispatch, launches
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_train
from torch_threads import torch_threads_per_worker  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 5e-3}


def _qkv(b, sq, skv, h, kh, hd, seed=17):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kh, hd)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.as_tensor(a).to(tdt) for a in arrays])


@pytest.mark.parametrize(
    "b,h,kh,sq,skv,hd,causal,window,qoff,dtype",
    [
        # the four cases of test_kernels.py::test_flash_pallas_vs_ref
        (2, 3, 3, 64, 64, 16, True, None, 0, "float32"),
        (1, 2, 2, 100, 100, 32, True, 24, 0, "float32"),
        (1, 2, 2, 1, 96, 16, True, None, 95, "float32"),
        (2, 2, 2, 48, 48, 16, False, None, 0, "bfloat16"),
        # grouped KV heads, causal and windowed, both dtypes
        (1, 8, 2, 40, 40, 16, True, None, 0, "float32"),
        (2, 8, 2, 37, 37, 32, True, 9, 0, "bfloat16"),
        (1, 8, 2, 33, 70, 16, True, 20, 37, "float32"),
        # head dim 96 (Phi-3-vision): causal MHA in fp32, a cross-attention
        # shape (Sq != Skv, no mask) in bf16
        (1, 4, 4, 40, 40, 96, True, None, 0, "float32"),
        (1, 4, 4, 5, 45, 96, False, None, 0, "bfloat16"),
    ],
)
def test_plain_flash_attention_vs_jax_ref_and_pallas(
    b, h, kh, sq, skv, hd, causal, window, qoff, dtype
):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, sq, skv, h, kh, hd), dtype)
    got = flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=qoff)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    tol = TOL[dtype]
    want = mha_reference(jq, jk, jv, causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), atol=tol, rtol=0)
    # the Pallas kernel takes (B, H, S, hd) with K/V repeated to H heads,
    # as the JAX dispatch wrapper hands them over
    jkr, jvr = (jnp.repeat(x, h // kh, axis=2) for x in (jk, jv))
    pallas = flash_attention_pallas(
        jq.transpose(0, 2, 1, 3), jkr.transpose(0, 2, 1, 3), jvr.transpose(0, 2, 1, 3),
        causal=causal, window=window, q_offset=qoff, block_q=16, block_kv=32,
        interpret=True,
    ).transpose(0, 2, 1, 3)
    rtol = 0 if dtype == "float32" else 2**-7
    np.testing.assert_allclose(got, np.asarray(pallas.astype(jnp.float32)), atol=tol, rtol=rtol)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2)])
def test_serving_form_vs_jax_per_lane(h, kh, window):
    """Per-lane kv_positions (ring order, -1 empty slots) and q_offset, one
    decode row per lane, against the JAX XLA serving path lane by lane."""
    b, skv, hd = 3, 24, 16
    q, k, v = _qkv(b, 1, skv, h, kh, hd, seed=5)
    pos = np.full((b, skv), -1, np.int64)
    pos[0] = skv + np.arange(skv)  # a full ring: slot j holds position 24 + j
    pos[1, :7] = np.arange(7)
    pos[2, :13] = np.arange(13)
    offsets = [47, 6, 12]  # each lane's query sits at its last written row
    got = flash_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal=True,
        window=window, q_offset=torch.as_tensor(offsets), kv_positions=torch.as_tensor(pos),
    ).numpy()
    for lane in range(b):
        want = jfops.flash_attention(
            jnp.asarray(q[lane:lane + 1]), jnp.asarray(k[lane:lane + 1]),
            jnp.asarray(v[lane:lane + 1]), causal=True, window=window,
            q_offset=jnp.asarray(offsets[lane]), kv_positions=jnp.asarray(pos[lane], jnp.int32),
            block_q=1, block_kv=8,
        )
        np.testing.assert_allclose(got[lane:lane + 1], np.asarray(want), atol=2e-5, rtol=0)


def test_dispatch_cpu_forcing_and_counts():
    q, k = torch.randn(1, 5, 4, 16), torch.randn(1, 5, 2, 16)
    assert dispatch.resolve("flash_attention", q) == "torch"
    launches.reset()
    out = dispatch.flash_attention(q, k, k, causal=True)
    torch.testing.assert_close(out, flash_attention(q, k, k, causal=True), rtol=0, atol=0)
    assert launches.snapshot()["flash_attention"] == {"cuda": 0, "torch": 1, "fake": 0}
    # the serving form runs the plain version whatever impl is forced, and
    # is not a launch of the kernel's function
    with dispatch.force_impl("cuda"):
        dispatch.flash_attention(q[:, :1], k, k, q_offset=torch.tensor([4]),
                                 kv_positions=torch.arange(5)[None])
        with pytest.raises(ValueError, match="CUDA tensor"):
            dispatch.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.flash_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_cuda(q, k, k)
    assert launches.snapshot()["flash_attention"] == {"cuda": 0, "torch": 1, "fake": 0}


# -------------------------------- the card's bf16 instance, emulated --
def _emulate_bf16_kernel(q, k, v, *, round_p=True, block_kv=64):
    """csrc/flash_attention.cu's bf16 arithmetic for one (batch, head) with
    the causal mask, before the output's bf16 rounding: scores of the bf16
    inputs in fp32, an online softmax over 64-key tiles, P rounded to bf16
    before P.V (``round_p``; l sums the fp32 P, as the Pallas kernel's
    does).  q (Sq, hd), k and v (Skv, hd) in bf16; returns fp32."""
    sq, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((sq, 1), -1e30)
    l = torch.zeros(sq, 1)
    acc = torch.zeros(sq, hd)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[0], block_kv):
        s = (qf @ kf[k0:k0 + block_kv].T) * hd**-0.5
        s = s.masked_fill(k0 + torch.arange(s.shape[1])[None, :] > rows, -1e30)
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * alpha + pv @ vf[k0:k0 + block_kv]
        m = m_new
    return acc / l.clamp_min(1e-30)


def _row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The card's bf16 gate: per query row, the largest error over the row's
    largest |want| entry; the worst row."""
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def test_bf16_kernel_emulation_meets_the_row_gate_at_2048():
    """One Yi-6B head at its longest prompt (Sq = Skv = 2048, hd 128,
    causal).  Rounding P to bf16 moves a row by at most ~3e-3 of its
    largest entry (each p by up to 2^-9; the worst rows have few keys),
    under 2^-8, so an entry in the row's top binade moves by less than one
    output step (2^-8 .. 2^-7 of the row's largest).  The emulated kernel
    output against the plain version (fp32 P, both rounded to bf16) then
    differs by at most one step, within the card's per-row gate of 1e-2
    with margin: at most 8e-3, above which the design would split P into
    two bf16 terms."""
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _qkv(1, 2048, 2048, 1, 1, 128, seed=3))
    args = (q[0, :, 0], k[0, :, 0], v[0, :, 0])
    kernel = _emulate_bf16_kernel(*args)
    assert _row_rel(kernel, _emulate_bf16_kernel(*args, round_p=False)) < 2**-8
    want = flash_attention(q, k, v, causal=True)[0, :, 0].float()
    assert _row_rel(kernel.to(torch.bfloat16).float(), want) <= 8e-3


def _max_rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@pytest.mark.parametrize(
    "b,h,kh,s,hd,causal,window,block",
    [
        (2, 4, 2, 32, 8, True, None, 8),    # causal GQA, S a multiple of the block
        (2, 4, 2, 37, 8, True, 12, 8),      # window < S, S off the block (padded)
        (1, 4, 4, 20, 16, True, None, 16),  # MHA, padded
        (2, 2, 1, 16, 8, False, None, 8),   # bidirectional, one KV head
        (2, 8, 2, 23, 8, True, 5, 4),       # small window, many tiles skipped
        (1, 4, 1, 9, 8, True, 4, 512),      # one tile: the block clamps to S
    ],
)
def test_training_attention_and_vjp_vs_jax(b, h, kh, s, hd, causal, window, block):
    import jax

    q, k, v = _qkv(b, s, s, h, kh, hd, seed=s)
    dout = np.random.default_rng(s + 1).standard_normal((b, s, h, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, block_q=block, block_kv=block)

    def jloss(q_, k_, v_):
        return jnp.sum(jfops.flash_attention(q_, k_, v_, **kw) * dout)

    jout = jfops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tout = flash_attention_train(tq, tk, tv, **kw)
    (tout * torch.as_tensor(dout)).sum().backward()
    assert tout.shape == (b, s, h, hd)
    assert _max_rel(tout.detach(), jout) < 2e-5
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert _max_rel(t.grad, j) < 2e-5, name


def test_training_attention_under_vmap():
    """``torch.func`` (the vmap oracle) runs through the autograd Function:
    per-sample gradients by vmap equal the per-sample calls."""
    from torch.func import grad, vmap

    rng = torch.Generator().manual_seed(0)
    q = torch.randn(3, 1, 13, 4, 8, generator=rng)
    k = torch.randn(3, 1, 13, 2, 8, generator=rng)
    v = torch.randn(3, 1, 13, 2, 8, generator=rng)

    def loss(q_, k_, v_):
        return flash_attention_train(q_, k_, v_, window=6, block_q=4, block_kv=4).square().sum()

    batched = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for i in range(3):
        single = grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i])
        for got, want in zip(batched, single):
            torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6)


def test_training_attention_bf16_keeps_dtype_and_runs_twice():
    """bf16 in, bf16 out and bf16 gradients (fp32 inside); a retained graph
    runs the backward twice with equal results (the second-backward modes)."""
    q, k, v = (torch.tensor(x).bfloat16().requires_grad_(True) for x in _qkv(2, 10, 10, 4, 2, 8))
    out = flash_attention_train(q, k, v, block_q=4, block_kv=4)
    assert out.dtype == torch.bfloat16
    first = torch.autograd.grad(out.float().sum(), (q, k, v), retain_graph=True)
    second = torch.autograd.grad(out.float().sum(), (q, k, v))
    for a, c in zip(first, second):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, c)
