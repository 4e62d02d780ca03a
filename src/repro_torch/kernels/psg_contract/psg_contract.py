"""The bank-contraction CUDA kernels and their plain versions.

Ports of ``kernels/psg_contract/psg_contract.py``:

- ``book_weighted_grad_cuda`` (``csrc/book_weighted_grad.cu``) replaces
  ``book_weighted_grad_pallas``: out[m] = sum_r w[m,r] a[m,r]^T g[m,r],
  with the weighted cotangent kept in shared memory;
- ``psg_contract_grouped_cuda`` (``csrc/psg_contract.cu``) replaces
  ``psg_contract_pallas``: out_s = sum_n c_s[n] psg_s[n] for a group of
  banks, each with its own row c_s of the clip factors (one row shared by
  all, or one per layer group), in one launch (``psg_contract_cuda`` is a
  group of one).

Each launches its kernel on CUDA tensors and raises on anything else.  The
``*_plain`` functions beside them are the same maps in plain PyTorch; the
``*_fake`` ones their abstract evaluation (``kernels.dispatch`` sends a fake
tensor there): the same allocations, the split laid out for the target
card's SMs (``checks.TARGET_SM_COUNT``), and a ``fake`` launch count where
each kernel would launch.  ``book_splits`` is the book kernel's split of R
across blocks.
"""
from __future__ import annotations

import array
import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import checks, launches
from repro_torch.kernels.psg_contract.ops import book_weighted_grad as book_weighted_grad_plain
from repro_torch.kernels.psg_contract.ops import psg_contract as psg_contract_plain
from repro_torch.kernels.psg_contract.ops import (
    psg_contract_grouped as psg_contract_grouped_plain,
)

__all__ = [
    "book_splits", "book_weighted_grad_cuda", "book_weighted_grad_fake",
    "book_weighted_grad_plain", "psg_contract_cuda", "psg_contract_grouped_cuda",
    "psg_contract_grouped_fake", "psg_contract_grouped_plain", "psg_contract_plain",
]

_MAX_GRID_Z = 65535
BOOK_TILE = 128  # D and p of one block's output tile (csrc/book_weighted_grad.cu)
BOOK_STEP = 32  # rows of R per k-step
MIN_ROWS_PER_SPLIT = 256  # a split of R runs at least 8 k-steps
MAX_SEGMENTS = 256  # bank descriptors one grouped launch takes (csrc/psg_contract.cu)


def book_splits(m: int, r: int, d: int, p: int, sm_count: int) -> tuple[int, int]:
    """(splits, rows_per_split) of the book kernel's R loop.

    Blocks own a 128 x 128 output tile of one m; where M x tiles falls short
    of two blocks per SM, R is cut into equal chunks (multiples of the
    32-row k-step, at least 256 rows) so the grid reaches about two per SM.
    """
    tiles = m * -(-d // BOOK_TILE) * -(-p // BOOK_TILE)
    splits = 1
    if tiles < 2 * sm_count:
        splits = max(1, min(-(-2 * sm_count // tiles), r // MIN_ROWS_PER_SPLIT))
    rows = -(-max(r, 1) // splits)
    rows = -(-rows // BOOK_STEP) * BOOK_STEP
    return -(-max(r, 1) // rows), rows


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _book_buffers(a: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                  sm_count: Optional[int]) -> tuple:
    """(out, partial, splits, rows) of one book call; ``partial`` None where
    no kernel runs (``out`` empty or zeroed: R = 0).  ``sm_count`` None:
    the SMs of ``a``'s card."""
    m, r, d = a.shape
    p = g.shape[2]
    if g.shape[:2] != (m, r) or tuple(w.shape) != (m, r):
        raise ValueError(
            f"a {tuple(a.shape)}, g {tuple(g.shape)}, w {tuple(w.shape)} disagree on (M, R)"
        )
    # the kernel counts rows in 32 bits and offsets elements in 64
    checks.fits_int32("R", r + 32)
    out = torch.empty((m, d, p), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out, None, 0, 0
    if r == 0:
        return out.zero_(), None, 0, 0
    splits, rows = book_splits(m, r, d, p, sm_count or _sm_count(a.device))
    if m * splits > _MAX_GRID_Z:
        raise ValueError(f"M * splits = {m * splits} exceeds the kernel's grid limit "
                         f"{_MAX_GRID_Z}")
    # the splits' partial sums, added in split order by a second kernel
    partial = torch.empty((splits, m, d, p) if splits > 1 else (0,), dtype=torch.float32,
                          device=a.device)
    return out, partial, splits, rows


def book_weighted_grad_cuda(
    a: torch.Tensor, g: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """a (M,R,D), g (M,R,p), each fp32 or bf16, w (M,R) fp32 -> (M,D,p) fp32."""
    from repro_torch.kernels.build import check, library

    checks.operand("a", a, 3)
    checks.operand("g", g, 3)
    checks.operand("w", w, 2, dtypes=(torch.float32,))
    checks.same_device(a=a, g=g, w=w)
    out, partial, splits, rows = _book_buffers(a, g, w, None)
    if partial is None:
        return out
    (m, r, d), p = a.shape, g.shape[2]
    with torch.cuda.device(a.device):
        code = library().book_weighted_grad_launch(
            a.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(),
            partial.data_ptr() if splits > 1 else None, m, r, d, p, splits, rows,
            checks.DTYPE_CODES[a.dtype], checks.DTYPE_CODES[g.dtype],
            checks.stream(a.device),
        )
    check(code, "book_weighted_grad")
    for _ in range(1 + (splits > 1)):  # the tile kernel, then the split sum
        launches.record("book_weighted_grad", "cuda")
    return out


def book_weighted_grad_fake(
    a: torch.Tensor, g: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """``book_weighted_grad_cuda``'s abstract evaluation."""
    out, partial, splits, _ = _book_buffers(a, g, w, checks.TARGET_SM_COUNT)
    if partial is not None:
        for _ in range(1 + (splits > 1)):
            launches.record("book_weighted_grad", "fake")
    return out


def psg_contract_grouped_cuda(
    psgs: Sequence[torch.Tensor], c: torch.Tensor, rows: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """psgs: banks (N, F_s), each fp32 or bf16; c (N,) fp32, or (G, N) fp32
    with ``rows[s]`` the row of bank s -> (sum F_s,) fp32, every bank's
    sum_n c_s[n] psg_s[n] back to back in list order.

    One launch per ``MAX_SEGMENTS`` banks (one for every list a training
    step gives); the descriptors, each with a pointer to its bank's factor
    row, go to the kernel by value.  The per-bank host work is kept to a few
    attribute reads: a step's call is short enough on the card that the
    host sets its time.
    """
    from repro_torch.kernels.build import check, library

    checks.operand("c", c, 2 if c.dim() == 2 else 1, dtypes=(torch.float32,))
    n, device = c.shape[-1], c.get_device()
    checks.fits_int32("N", n)
    row_ptrs = _factor_rows(c, rows, len(psgs))
    table, total = array.array("q"), 0  # 5 int64 a bank: psg, out offset, F, dtype, c row
    for i, psg in enumerate(psgs):
        if not (psg.is_cuda and psg.dim() == 2 and psg.dtype in checks.FLOATS
                and psg.is_contiguous() and psg.get_device() == device):
            _refuse(f"psgs[{i}]", psg, c)
        n_i, f = psg.shape
        if n_i != n:
            _refuse(f"psgs[{i}]", psg, c)
        if f:
            table.extend((psg.data_ptr(), total, f, checks.DTYPE_CODES[psg.dtype], row_ptrs[i]))
        total += f
    out = torch.empty((total,), dtype=torch.float32, device=c.device)
    if not table:
        return out
    if n == 0:
        return out.zero_()
    base = out.data_ptr()
    for j in range(1, len(table), 5):
        table[j] = base + 4 * table[j]
    with torch.cuda.device(c.device):
        for first in range(0, len(table), 5 * MAX_SEGMENTS):
            chunk = table[first:first + 5 * MAX_SEGMENTS]
            ctable = (ctypes.c_int64 * len(chunk)).from_buffer(chunk)
            code = library().psg_contract_grouped_launch(
                ctable, len(chunk) // 5, n, checks.stream(c.device))
            check(code, "psg_contract")
            launches.record("psg_contract", "cuda")
    return out


def psg_contract_grouped_fake(
    psgs: Sequence[torch.Tensor], c: torch.Tensor, rows: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """``psg_contract_grouped_cuda``'s abstract evaluation: its output, and
    one launch per ``MAX_SEGMENTS`` non-empty banks."""
    n = c.shape[-1]
    if rows is not None and len(rows) != len(psgs):
        raise ValueError(f"{len(psgs)} banks, {len(rows)} row indices")
    for i, psg in enumerate(psgs):
        if psg.dim() != 2 or psg.shape[0] != n:
            raise ValueError(f"psgs[{i}] {tuple(psg.shape)} and c {tuple(c.shape)} "
                             "disagree on N")
    banks = sum(1 for psg in psgs if psg.shape[1])
    out = torch.empty((sum(psg.shape[1] for psg in psgs),), dtype=torch.float32,
                      device=c.device)
    if not banks:
        return out
    if n == 0:
        return out.zero_()
    for _ in range(-(-banks // MAX_SEGMENTS)):
        launches.record("psg_contract", "fake")
    return out


def _factor_rows(c: torch.Tensor, rows: Optional[Sequence[int]], n_banks: int) -> list[int]:
    """Each bank's factor-row pointer: c itself when it is (N,), row
    ``rows[s]`` of a (G, N) c."""
    if c.dim() == 1:
        if rows is not None:
            raise ValueError("rows index a (G, N) factor matrix; c is (N,)")
        return [c.data_ptr()] * n_banks
    if rows is None or len(rows) != n_banks:
        raise ValueError(f"a (G, N) factor matrix needs one row index per bank "
                         f"({n_banks}), got {rows!r}")
    g, n = c.shape
    if any(not 0 <= r < g for r in rows):
        raise ValueError(f"row indices {list(rows)} outside the {g} rows of c")
    return [c.data_ptr() + 4 * n * r for r in rows]


def _refuse(name: str, psg: torch.Tensor, c: torch.Tensor) -> None:
    """Raise the reason a bank cannot go to the grouped kernel."""
    checks.operand(name, psg, 2)
    checks.same_device(psg=psg, c=c)
    raise ValueError(f"{name} {tuple(psg.shape)} and c {tuple(c.shape)} disagree on N")


def psg_contract_cuda(psg: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """psg (N, F) fp32 or bf16, c (N,) fp32 -> (F,) fp32: a group of one."""
    return psg_contract_grouped_cuda([psg], c)
