"""The ghost-norm CUDA kernels (``csrc/ghost_norm.cu``, ``csrc/embedding_norm.cu``)
and their plain versions.

Ports of ``kernels/ghost_norm/ghost_norm.py``:

- ``ghost_norm_sq_cuda`` replaces ``ghost_norm_sq_pallas``: per sample,
  sum_{t,t'} (a_t . a_t') (g_t . g_t') with the (T, T) Gram tiles kept on
  chip, on the tensor cores;
- ``conv_ghost_norm_sq_cuda`` is the same kernel reading a conv tap's raw
  NHWC input and building the patches on chip (no im2col); it counts as a
  ``ghost_norm_sq`` launch;
- ``embedding_ghost_norm_sq_cuda`` replaces
  ``embedding_ghost_norm_sq_pallas``: sum_{t,t'} [id_t = id_t'] (g_t . g_t'),
  computed as the sum over distinct ids of |sum of g_t with that id|^2: a
  per-sample sort of the positions by id, then a segment sum of g's rows
  in sorted order (``embedding_plan`` splits it over the card).

Each launches its kernel on CUDA tensors and raises on anything else; the
``*_plain`` functions beside them are the same maps in plain PyTorch,
which the CPU tests and ``chip_smoke.py`` compare them with.  The
``*_fake`` functions are their abstract evaluation (``kernels.dispatch``
sends a fake tensor there): the same output and workspace allocations, laid
out for the target card (``checks.TARGET_*``), and a ``fake`` launch count
where the kernel would launch; nothing runs.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.taps import ConvInfo
from repro_torch.kernels import checks, launches
from repro_torch.kernels.ghost_norm.ops import (
    conv_ghost_norm_sq as conv_ghost_norm_sq_plain,
)
from repro_torch.kernels.ghost_norm.ops import (
    embedding_ghost_norm_sq as embedding_ghost_norm_sq_plain,
)
from repro_torch.kernels.ghost_norm.ops import ghost_norm_sq as ghost_norm_sq_plain
from repro_torch.nn.conv import conv_padding

__all__ = [
    "conv_ghost_norm_sq_cuda", "conv_ghost_norm_sq_plain",
    "conv_ghost_norm_sq_fake", "embedding_ghost_norm_sq_cuda", "embedding_ghost_norm_sq_fake",
    "embedding_ghost_norm_sq_plain", "embedding_plan", "embedding_slots",
    "embedding_sort_capacity", "ghost_norm_sq_cuda", "ghost_norm_sq_fake",
    "ghost_norm_sq_plain", "tile_for",
]


def tile_for(t: int) -> int:
    """Tile edge of the Gram kernels' (T, T) plane: 16 for T <= 16 (the
    packed kernel: one m16 tile holds a sample's whole Gram, floor(16 / T)
    samples a tile for T <= 8), else 64 (the tiles kernel)."""
    return 16 if t <= 16 else 64


# the embedding kernel's segment pass: warps a block (kWarps in
# csrc/embedding_norm.cu), and the least sorted positions a warp's range is
# cut to
EMBED_WARPS = 8
EMBED_MIN_ROWS = 8


def embedding_plan(n: int, t: int, p: int, vec: int, slots: int) -> tuple[int, int]:
    """(slices, blocks) of the embedding kernel's segment pass.

    A warp owns 32 lanes x ``vec`` columns (16 bytes a lane) of every row
    over one range of sorted positions; each (sample, slice) is cut into
    ``EMBED_WARPS * blocks`` ranges.  ``blocks`` fills the card's ``slots``
    (SMs x the blocks an SM holds) in one wave, every (sample, slice) alike,
    but cuts no range under ``EMBED_MIN_ROWS`` positions (at least one
    block)."""
    slices = -(-p // (32 * vec))
    most = t // (EMBED_WARPS * EMBED_MIN_ROWS)
    return slices, max(1, min(slots // (n * slices), most))


@functools.lru_cache(maxsize=None)
def embedding_slots(index: int, g_dtype: torch.dtype) -> int:
    """Card ``index``'s block slots for the segment pass over g of
    ``g_dtype``: SMs x the blocks an SM holds."""
    from repro_torch.kernels.build import library

    with torch.cuda.device(index):
        per_sm = library().embedding_segment_blocks_per_sm(checks.DTYPE_CODES[g_dtype])
    if per_sm < 1:
        raise RuntimeError("embedding_ghost_norm_sq: the segment kernel fits no SM")
    return torch.cuda.get_device_properties(index).multi_processor_count * per_sm


@functools.lru_cache(maxsize=None)
def embedding_sort_capacity(index: int) -> int:
    """The most positions a sample may have for card ``index`` to sort it
    in shared memory (above, through a workspace in device memory)."""
    from repro_torch.kernels.build import library

    with torch.cuda.device(index):
        return library().embedding_sort_capacity()


def _pairs(n: int, t: int, tile: int,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (N,) output and the per-(sample, tile pair) partials (the output
    itself when a sample has a single pair)."""
    n_tiles = -(-t // tile)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    checks.fits_int32("N * tile pairs", n * n_pairs)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    partial = out if n_pairs == 1 else torch.empty(
        (n * n_pairs,), dtype=torch.float32, device=device
    )
    return out, partial


def _dense_dims(a: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int, int]:
    n, t, d = a.shape
    if g.shape[:2] != (n, t):
        raise ValueError(f"a {tuple(a.shape)} and g {tuple(g.shape)} disagree on (N, T)")
    p = g.shape[2]
    for name, size in (("T * D", t * d), ("T * p", t * p)):
        checks.fits_int32(name, size)
    return n, t, d, p


def ghost_norm_sq_cuda(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a (N, T, D), g (N, T, p), each fp32 or bf16 -> (N,) fp32."""
    from repro_torch.kernels.build import check, library

    checks.operand("a", a, 3)
    checks.operand("g", g, 3)
    checks.same_device(a=a, g=g)
    n, t, d, p = _dense_dims(a, g)
    if a.numel() == 0 or g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=a.device)
    tile = tile_for(t)
    out, partial = _pairs(n, t, tile, a.device)
    with torch.cuda.device(a.device):
        code = library().ghost_norm_sq_launch(
            a.data_ptr(), g.data_ptr(), out.data_ptr(), partial.data_ptr(),
            n, t, d, p, checks.DTYPE_CODES[a.dtype], checks.DTYPE_CODES[g.dtype], tile,
            checks.stream(a.device),
        )
    check(code, "ghost_norm_sq")
    launches.record("ghost_norm_sq", "cuda")
    return out


def ghost_norm_sq_fake(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``ghost_norm_sq_cuda``'s abstract evaluation (module docstring)."""
    n, t, _, _ = _dense_dims(a, g)
    if a.numel() == 0 or g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=a.device)
    out, _ = _pairs(n, t, tile_for(t), a.device)
    launches.record("ghost_norm_sq", "fake")
    return out


def _conv_dims(x: torch.Tensor, g: torch.Tensor, info: ConvInfo) -> tuple:
    """(n, h, w, c, p, t, padding) of a conv tap's ghost norm."""
    n, h, w, c = x.shape
    (kh, kw), (sh, sw) = info.kernel, info.strides
    pads = conv_padding(info.padding, (h, w), info.kernel, info.strides)
    (pt, pb), (pl, pr) = pads
    h_out, w_out = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    t = h_out * w_out
    if h_out < 1 or w_out < 1 or g.shape[:2] != (n, t):
        raise ValueError(f"x {tuple(x.shape)} under {info} gives (N, T) = ({n}, {t}); "
                         f"g is {tuple(g.shape)}")
    p = g.shape[2]
    for name, size in (("H * W * C", h * w * c), ("T * D", t * kh * kw * c), ("T * p", t * p)):
        checks.fits_int32(name, size)
    return n, h, w, c, p, t, pads


def conv_ghost_norm_sq_cuda(x: torch.Tensor, g: torch.Tensor, info: ConvInfo) -> torch.Tensor:
    """x (N, H, W, C) the raw NHWC input of a 2-D conv tap, g (N, H_out *
    W_out, p), each fp32 or bf16 -> (N,) fp32: ghost_norm_sq(unfold2d(x), g)."""
    from repro_torch.kernels.build import check, library

    checks.operand("x", x, 4)
    checks.operand("g", g, 3)
    checks.same_device(x=x, g=g)
    n, h, w, c, p, t, ((pt, pb), (pl, pr)) = _conv_dims(x, g, info)
    (kh, kw), (sh, sw) = info.kernel, info.strides
    if x.numel() == 0 or g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=x.device)
    tile = tile_for(t)
    out, partial = _pairs(n, t, tile, x.device)
    with torch.cuda.device(x.device):
        code = library().conv_ghost_norm_sq_launch(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), partial.data_ptr(),
            n, h, w, c, kh, kw, sh, sw, pt, pb, pl, pr, p,
            checks.DTYPE_CODES[x.dtype], checks.DTYPE_CODES[g.dtype], tile,
            checks.stream(x.device),
        )
    check(code, "conv_ghost_norm_sq")
    launches.record("ghost_norm_sq", "cuda")
    return out


def conv_ghost_norm_sq_fake(x: torch.Tensor, g: torch.Tensor, info: ConvInfo) -> torch.Tensor:
    """``conv_ghost_norm_sq_cuda``'s abstract evaluation: counts as
    ``ghost_norm_sq``."""
    n, _, _, _, _, t, _ = _conv_dims(x, g, info)
    if x.numel() == 0 or g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=x.device)
    out, _ = _pairs(n, t, tile_for(t), x.device)
    launches.record("ghost_norm_sq", "fake")
    return out


def _embedding_dims(ids: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int]:
    n, t = ids.shape
    if g.shape[:2] != (n, t):
        raise ValueError(f"ids {tuple(ids.shape)} and g {tuple(g.shape)} disagree on (N, T)")
    p = g.shape[2]
    checks.fits_int32("T * p", t * p)
    return n, t, p


def _embedding_workspace(n: int, t: int, p: int, g: torch.Tensor, slots: int,
                         capacity: int) -> tuple:
    """(workspace, slices, blocks, word offsets of the order, the units and
    the sort's buffers (None: sorted in shared memory)) of one call, for a
    card with ``slots`` segment-pass block slots that sorts up to
    ``capacity`` positions a sample in shared memory."""
    vec = 16 // g.element_size()
    slices, blocks = embedding_plan(n, t, p, vec, slots)
    units = n * slices * blocks
    checks.fits_int32("N * slices * blocks", units)
    # one allocation, each part 16-byte aligned: the (N,) output, the sorted
    # order, the segment pass's units (64 * vec + 2 words each), and where
    # the sort does not fit in shared memory its 64-bit keys, two orders and
    # ranks (5 words a position)
    n_out, n_order = -(-n // 4) * 4, -(-n * t // 4) * 4
    n_units = units * (64 * vec + 2)
    n_sort = 0 if t <= capacity else 5 * n * t
    ws = torch.empty((n_out + n_order + n_units + n_sort,), dtype=torch.float32,
                     device=g.device)
    at_units = n_out + n_order
    return ws, slices, blocks, (n_out, at_units, at_units + n_units if n_sort else None)


def embedding_ghost_norm_sq_cuda(ids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ids (N, T) int32 or int64, g (N, T, p) fp32 or bf16 -> (N,) fp32."""
    from repro_torch.kernels.build import check, library

    checks.operand("ids", ids, 2, dtypes=checks.IDS)
    checks.operand("g", g, 3)
    checks.same_device(ids=ids, g=g)
    n, t, p = _embedding_dims(ids, g)
    if g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=g.device)
    ws, slices, blocks, (at_order, at_units, at_sort) = _embedding_workspace(
        n, t, p, g, embedding_slots(g.device.index, g.dtype),
        embedding_sort_capacity(g.device.index))
    out = ws[:n]
    base, word = ws.data_ptr(), ws.element_size()
    with torch.cuda.device(g.device):
        code = library().embedding_ghost_norm_sq_launch(
            ids.data_ptr(), g.data_ptr(), base, base + at_order * word, base + at_units * word,
            None if at_sort is None else base + at_sort * word,
            n, t, p, checks.DTYPE_CODES[ids.dtype], checks.DTYPE_CODES[g.dtype], slices,
            blocks, checks.stream(g.device),
        )
    check(code, "embedding_ghost_norm_sq")
    launches.record("embedding_ghost_norm_sq", "cuda")
    return out


def embedding_ghost_norm_sq_fake(ids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``embedding_ghost_norm_sq_cuda``'s abstract evaluation."""
    n, t, p = _embedding_dims(ids, g)
    if g.numel() == 0:
        return torch.zeros((n,), dtype=torch.float32, device=g.device)
    slots = checks.TARGET_SM_COUNT * checks.TARGET_EMBED_BLOCKS_PER_SM[g.dtype]
    ws = _embedding_workspace(n, t, p, g, slots, checks.TARGET_EMBED_SORT_CAPACITY)[0]
    launches.record("embedding_ghost_norm_sq", "fake")
    return ws[:n]
