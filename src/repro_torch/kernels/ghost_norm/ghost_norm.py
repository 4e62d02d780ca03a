"""The ghost-norm CUDA kernels (``csrc/ghost_norm.cu``) and their plain versions.

Ports of ``kernels/ghost_norm/ghost_norm.py``:

- ``ghost_norm_sq_cuda`` replaces ``ghost_norm_sq_pallas``: per sample,
  sum_{t,t'} (a_t . a_t') (g_t . g_t') with the (T, T) Gram tiles kept on
  chip;
- ``embedding_ghost_norm_sq_cuda`` replaces
  ``embedding_ghost_norm_sq_pallas``: the same with the activation Gram
  replaced by the equality mask of the ids, sum_{t,t'} [id_t = id_t']
  (g_t . g_t').

Each launches its kernel on CUDA tensors and raises on anything else; the
``*_plain`` functions beside them are the same maps in plain PyTorch,
which the CPU tests and ``chip_smoke.py`` compare them with.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import checks, launches
from repro_torch.kernels.ghost_norm.ops import (
    embedding_ghost_norm_sq as embedding_ghost_norm_sq_plain,
)
from repro_torch.kernels.ghost_norm.ops import ghost_norm_sq as ghost_norm_sq_plain

__all__ = [
    "embedding_ghost_norm_sq_cuda", "embedding_ghost_norm_sq_plain",
    "ghost_norm_sq_cuda", "ghost_norm_sq_plain", "tile_for",
]


def tile_for(t: int) -> int:
    """Tile edge of the (T, T) plane: 16 for short sequences, else 32."""
    return 16 if t <= 16 else 32


def _pairs(n: int, t: int, device: torch.device) -> tuple[int, torch.Tensor, torch.Tensor]:
    """Tile edge, the (N,) output and the per-(sample, tile pair) partials
    (the output itself when a sample has a single pair)."""
    tile = tile_for(t)
    n_tiles = -(-t // tile)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    checks.fits_int32("N * tile pairs", n * n_pairs)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    partial = out if n_pairs == 1 else torch.empty(
        (n * n_pairs,), dtype=torch.float32, device=device
    )
    return tile, out, partial


def ghost_norm_sq_cuda(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a (N, T, D), g (N, T, p), each fp32 or bf16 -> (N,) fp32."""
    from repro_torch.kernels.build import check, library

    checks.operand("a", a, 3)
    checks.operand("g", g, 3)
    checks.same_device(a=a, g=g)
    n, t, d = a.shape
    if g.shape[:2] != (n, t):
        raise ValueError(f"a {tuple(a.shape)} and g {tuple(g.shape)} disagree on (N, T)")
    p = g.shape[2]
    if a.numel() == 0 or g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=a.device)
    for name, size in (("T * D", t * d), ("T * p", t * p)):
        checks.fits_int32(name, size)
    tile, out, partial = _pairs(n, t, a.device)
    with torch.cuda.device(a.device):
        code = library().ghost_norm_sq_launch(
            a.data_ptr(), g.data_ptr(), out.data_ptr(), partial.data_ptr(),
            n, t, d, p, checks.DTYPE_CODES[a.dtype], checks.DTYPE_CODES[g.dtype], tile,
            checks.stream(a.device),
        )
    check(code, "ghost_norm_sq")
    launches.record("ghost_norm_sq", "cuda")
    return out


def embedding_ghost_norm_sq_cuda(ids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ids (N, T) int32 or int64, g (N, T, p) fp32 or bf16 -> (N,) fp32."""
    from repro_torch.kernels.build import check, library

    checks.operand("ids", ids, 2, dtypes=checks.IDS)
    checks.operand("g", g, 3)
    checks.same_device(ids=ids, g=g)
    n, t = ids.shape
    if g.shape[:2] != (n, t):
        raise ValueError(f"ids {tuple(ids.shape)} and g {tuple(g.shape)} disagree on (N, T)")
    p = g.shape[2]
    if g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=g.device)
    checks.fits_int32("T * p", t * p)
    tile, out, partial = _pairs(n, t, g.device)
    with torch.cuda.device(g.device):
        code = library().embedding_ghost_norm_sq_launch(
            ids.data_ptr(), g.data_ptr(), out.data_ptr(), partial.data_ptr(),
            n, t, p, checks.DTYPE_CODES[ids.dtype], checks.DTYPE_CODES[g.dtype], tile,
            checks.stream(g.device),
        )
    check(code, "embedding_ghost_norm_sq")
    launches.record("embedding_ghost_norm_sq", "cuda")
    return out
