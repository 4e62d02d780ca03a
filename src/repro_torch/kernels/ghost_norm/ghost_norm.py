"""The ghost-norm CUDA kernel (``csrc/ghost_norm.cu``) and its plain version.

Port of ``kernels/ghost_norm/ghost_norm.py::ghost_norm_sq_pallas``: per
sample, sum_{t,t'} (a_t . a_t') (g_t . g_t') with the (T, T) Gram tiles
kept on chip.  ``ghost_norm_sq_cuda`` launches the kernel on a CUDA tensor
and raises on anything else; ``ghost_norm_sq_plain`` is the same function
in plain PyTorch, which the CPU tests and ``chip_smoke.py`` compare it with.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks, launches
from repro_torch.kernels.ghost_norm.ops import ghost_norm_sq as ghost_norm_sq_plain

__all__ = ["ghost_norm_sq_cuda", "ghost_norm_sq_plain", "tile_for"]


def tile_for(t: int) -> int:
    """Tile edge of the (T, T) plane: 16 for short sequences, else 32."""
    return 16 if t <= 16 else 32


def ghost_norm_sq_cuda(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a (N, T, D), g (N, T, p), same dtype (fp32 or bf16) -> (N,) fp32."""
    from repro_torch.kernels.build import check, library

    checks.operand("a", a, 3)
    checks.operand("g", g, 3, dtypes=(a.dtype,))
    checks.same_device(a=a, g=g)
    n, t, d = a.shape
    if g.shape[:2] != (n, t):
        raise ValueError(f"a {tuple(a.shape)} and g {tuple(g.shape)} disagree on (N, T)")
    p = g.shape[2]
    out = torch.empty((n,), dtype=torch.float32, device=a.device)
    if a.numel() == 0 or g.numel() == 0:
        return out.zero_()
    tile = tile_for(t)
    n_tiles = -(-t // tile)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    checks.fits_int32("N * tile pairs", n * n_pairs)
    for name, size in (("T * D", t * d), ("T * p", t * p)):
        checks.fits_int32(name, size)
    partial = out if n_pairs == 1 else torch.empty(
        (n * n_pairs,), dtype=torch.float32, device=a.device
    )
    with torch.cuda.device(a.device):
        code = library().ghost_norm_sq_launch(
            a.data_ptr(), g.data_ptr(), out.data_ptr(), partial.data_ptr(),
            n, t, d, p, checks.DTYPE_CODES[a.dtype], tile, checks.stream(a.device),
        )
    check(code, "ghost_norm_sq")
    launches.record("ghost_norm_sq", "cuda")
    return out
