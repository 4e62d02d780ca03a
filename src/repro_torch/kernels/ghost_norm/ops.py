"""Plain PyTorch per-sample gradient norms (port of ``kernels/ghost_norm/ops.py``).

``ghost_norm_sq``, ``conv_ghost_norm_sq`` and ``embedding_ghost_norm_sq``
are the plain versions of the CUDA kernels in ``ghost_norm.py``: the same
sums over (T x T) tiles, with the tile Grams formed by ``torch.bmm`` (the
conv entry from ``unfold2d``'s patches).  ``instantiated_norm_sq`` had no
TPU kernel and stays plain.  Which one the training step runs is decided
by ``repro_torch.kernels.dispatch``, not here: calling these functions
always runs the plain path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.taps import ConvInfo
from repro_torch.nn.conv import unfold2d

_DIRECT_T = 1024  # below this, one pair of full Grams beats the tile loop


def _pad_axis(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def pad_ids_pair(ids: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad the two id operands of an index-equality Gram to a block multiple.

    The left and right operands get *different* sentinel ids (-1 and -2), so
    a pad position never matches a real id (ids are non-negative), the other
    operand's pad, or its own mirror on a diagonal tile: the equality mask
    is exactly zero at every padded position, whatever the padding of g.
    Returns ``(ids_i, ids_j)``; both are the input when T is a multiple of
    ``block``.
    """
    pad = (-ids.shape[1]) % block
    if pad == 0:
        return ids, ids
    return F.pad(ids, (0, pad), value=-1), F.pad(ids, (0, pad), value=-2)


def _gram_dot(a_i, a_j, g_i, g_j) -> torch.Tensor:
    gram_a = torch.bmm(a_i.float(), a_j.float().transpose(1, 2))
    gram_g = torch.bmm(g_i.float(), g_j.float().transpose(1, 2))
    return (gram_a * gram_g).sum(dim=(1, 2))


def ghost_norm_sq(a: torch.Tensor, g: torch.Tensor, *, block: int = 512) -> torch.Tensor:
    """Ghost norm (Eq. 2.7): a (N, T, D), g (N, T, p) -> (N,) fp32.

    Inputs stay in their storage dtype; tiles are upcast one at a time.
    Symmetry halves the tile loop: total = sum_i w_ii + 2 sum_{i<j} w_ij.
    """
    t = a.shape[1]
    if t <= max(block, _DIRECT_T):
        return _gram_dot(a, a, g, g)
    a = _pad_axis(a, 1, block)
    g = _pad_axis(g, 1, block)
    nb = a.shape[1] // block
    acc = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for i in range(nb):
        si = slice(i * block, (i + 1) * block)
        for j in range(i + 1):
            sj = slice(j * block, (j + 1) * block)
            w = 1.0 if i == j else 2.0
            acc = acc + w * _gram_dot(a[:, si], a[:, sj], g[:, si], g[:, sj])
    return acc


def conv_ghost_norm_sq(
    x: torch.Tensor, g: torch.Tensor, info: ConvInfo, *, block: int = 512
) -> torch.Tensor:
    """Ghost norm of a conv tap from its raw NHWC input: x (N, H, W, C),
    g (N, H_out*W_out, p) -> (N,) fp32, as ``ghost_norm_sq(unfold2d(x), g)``."""
    return ghost_norm_sq(unfold2d(x, info), g, block=block)


def instantiated_norm_sq(
    a: torch.Tensor, g: torch.Tensor, *, block_d: int = 4096
) -> torch.Tensor:
    """|| a^T g ||_F^2 per row, streaming over fan-in blocks.

    a: (N, T, D), g: (N, T, p) -> (N,) fp32.
    """
    gf = g.float()
    acc = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for d0 in range(0, a.shape[2], block_d):
        part = torch.bmm(a[:, :, d0 : d0 + block_d].float().transpose(1, 2), gf)
        acc = acc + (part * part).sum(dim=(1, 2))
    return acc


def _eq_gram_dot(id_i, id_j, g_i, g_j) -> torch.Tensor:
    eq = (id_i[:, :, None] == id_j[:, None, :]).float()
    gram_g = torch.bmm(g_i.float(), g_j.float().transpose(1, 2))
    return (eq * gram_g).sum(dim=(1, 2))


def embedding_ghost_norm_sq(
    ids: torch.Tensor, g: torch.Tensor, *, block: int = 1024
) -> torch.Tensor:
    """Index-equality ghost norm: sum_{t,t'} [id_t == id_t'] (g_t . g_t').

    ids (N, T) int, g (N, T, p) -> (N,) fp32: the squared Frobenius norm of
    each sample's embedding gradient (a scatter-add of g rows by id),
    without forming it.
    """
    t = g.shape[1]
    if t <= max(block, _DIRECT_T):
        return _eq_gram_dot(ids, ids, g, g)
    ids_i, ids_j = pad_ids_pair(ids, block)
    g = _pad_axis(g, 1, block)
    nb = g.shape[1] // block
    acc = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
    for i in range(nb):
        si = slice(i * block, (i + 1) * block)
        for j in range(i + 1):
            sj = slice(j * block, (j + 1) * block)
            w = 1.0 if i == j else 2.0
            acc = acc + w * _eq_gram_dot(ids_i[:, si], ids_j[:, sj], g[:, si], g[:, sj])
    return acc
