"""Plain PyTorch bank contractions (port of ``kernels/psg_contract/ops.py``).

The plain versions of the two CUDA kernels in ``psg_contract.py``.  The
book contraction is one three-operand einsum, which materializes the
weighted cotangent ``g * w`` that the kernel keeps in shared memory.
"""
from __future__ import annotations

import torch


def book_weighted_grad(a: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_r w[m,r] a[m,r]^T g[m,r].  a: (M,R,D), g: (M,R,p), w: (M,R) -> (M,D,p)."""
    return torch.einsum("mrd,mrp,mr->mdp", a.float(), g.float(), w.float())


def psg_contract(psg: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_n c[n] * psg[n].  psg: (N, F), c: (N,) -> (F,) float32."""
    return torch.einsum("nf,n->f", psg.float(), c.float())
