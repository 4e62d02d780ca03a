"""The attention-forward CUDA kernel (``csrc/flash_attention.cu``) and its
plain version.

``flash_attention_cuda`` replaces ``flash_attention_pallas``
(``kernels/flash_attention/flash_attention.py``): online-softmax attention
over the static causal / window masks with an int ``q_offset``, fully
masked KV tiles skipped.  It takes the JAX public layout, q (B, Sq, H, hd)
and k/v (B, Skv, K, hd), and reads KV head ``h // (H / K)`` in place where
the Pallas wrapper repeats K and V to H heads.  bf16 inputs run on the
tensor cores (P rounded to bf16 before P.V, as the Pallas kernel does):
head dims 64 and 128 through the warpgroup-MMA instance fed by TMA, 16,
32 and 96 (Phi-3-vision) through the mma.sync one; fp32 inputs run the
fp32 SIMT instance.  Any other head dim raises: there is no fallback.  The
TMA tensor maps need 16-byte-aligned rows, so a view at an odd offset is
copied first.  It launches its kernel on
CUDA tensors and raises on anything else; ``flash_attention_plain`` beside
it is the same map in plain PyTorch, and ``flash_attention_fake`` its
abstract evaluation (``kernels.dispatch`` sends a fake tensor there): the
output, the copies of views at odd offsets, and a ``fake`` launch count.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import checks, launches
from repro_torch.kernels.flash_attention.ops import flash_attention as flash_attention_plain

__all__ = ["HEAD_DIMS", "flash_attention_cuda", "flash_attention_fake",
           "flash_attention_plain"]

HEAD_DIMS = (16, 32, 64, 96, 128)  # the kernel's template instances
_MAX_GRID_YZ = 65535


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
                  q_offset: int) -> None:
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, skv, kh, hd) or v.shape != k.shape:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: expected "
            "q (B,Sq,H,hd) and k = v (B,Skv,K,hd)"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    if max(h, b, -(-sq // 64)) > _MAX_GRID_YZ:
        raise ValueError(f"B = {b}, H = {h} or Sq / 64 = {-(-sq // 64)} exceeds the kernel's "
                         f"grid limit {_MAX_GRID_YZ}")
    if window is not None and window < 0:
        raise ValueError(f"window {window} must be non-negative")
    for name, size in (("B*Sq*H*hd", q.numel()), ("B*Skv*K*hd", k.numel()),
                       ("|q_offset| + Sq + Skv", abs(q_offset) + sq + skv)):
        checks.fits_int32(name, size)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,K,hd), one dtype (fp32 or bf16) -> (B,Sq,H,hd)."""
    from repro_torch.kernels.build import check, library

    for name, x in (("q", q), ("k", k), ("v", v)):
        checks.operand(name, x, 4)
    checks.same_device(q=q, k=k, v=v)
    _check_shapes(q, k, v, window, q_offset)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # the bf16 instances copy 16-byte chunks; a view at an odd offset is copied
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        code = library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, h, kh, hd, int(causal), -1 if window is None else window,
            q_offset, hd**-0.5, checks.DTYPE_CODES[q.dtype], checks.stream(q.device),
        )
    check(code, "flash_attention")
    launches.record("flash_attention", "cuda")
    return out


def flash_attention_fake(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
) -> torch.Tensor:
    """``flash_attention_cuda``'s abstract evaluation (the allocator's blocks
    start 16-byte aligned, so a view's offset decides its copy)."""
    del causal
    _check_shapes(q, k, v, window, q_offset)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # a view at an odd offset is copied, and the copy lives through the launch
    _copies = [x.clone() for x in (q, k, v) if x.storage_offset() * x.element_size() % 16]
    launches.record("flash_attention", "fake")
    return out
