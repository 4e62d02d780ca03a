"""Plain PyTorch bank contractions (port of ``kernels/psg_contract/ops.py``).

The plain versions of the two CUDA kernels in ``psg_contract.py``.  The
book contraction materializes the weighted cotangent ``g * w`` (which the
kernel keeps in shared memory) and contracts it in one batched matmul; a
three-operand einsum would depend on ``opt_einsum`` to avoid an
(M, R, D, p) intermediate.  ``psg_contract_grouped`` is the grouped bank
kernel's plain version: one einsum per bank against its own factor row,
the sums concatenated.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def book_weighted_grad(a: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_r w[m,r] a[m,r]^T g[m,r].  a: (M,R,D), g: (M,R,p), w: (M,R) -> (M,D,p)."""
    return torch.bmm(a.float().transpose(1, 2), g.float() * w.float()[..., None])


def psg_contract(psg: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_n c[n] * psg[n].  psg: (N, F), c: (N,) -> (F,) float32."""
    return torch.einsum("nf,n->f", psg.float(), c.float())


def psg_contract_grouped(
    psgs: Sequence[torch.Tensor], c: torch.Tensor, rows: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """sum_n c_s[n] * psg_s[n] of every bank in ``psgs`` (each (N, F_s)),
    one einsum per bank; the (F_s,) float32 sums back to back, (sum F_s,).
    ``c`` is (N,), shared by every bank, or (G, N) with ``rows[s]`` the
    row of bank s."""
    if c.dim() == 1:
        if rows is not None:
            raise ValueError("rows index a (G, N) factor matrix; c is (N,)")
        cs = [c] * len(psgs)
    else:
        if rows is None or len(rows) != len(psgs):
            raise ValueError(f"a (G, N) factor matrix needs one row index per bank "
                             f"({len(psgs)}), got {rows!r}")
        cs = [c[r] for r in rows]
    if not psgs:
        return torch.zeros((0,), dtype=torch.float32, device=c.device)
    return torch.cat([psg_contract(psg, ci) for psg, ci in zip(psgs, cs)])
