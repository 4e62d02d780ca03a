"""Kernel dispatch for the clipping and attention hot ops (port of
``kernels/dispatch.py``).

The hand-written CUDA kernels (``ghost_norm/ghost_norm.py``,
``psg_contract/psg_contract.py``, ``flash_attention/flash_attention.py``)
and their plain PyTorch versions (``*/ops.py``) compute the same values;
this module is the one place that picks between them:

    op                    cuda impl                     torch impl
    --------------------  ----------------------------  ---------------------------
    ghost_norm            ghost_norm_sq_cuda /          gops.ghost_norm_sq /
                          conv_ghost_norm_sq_cuda       gops.conv_ghost_norm_sq
    embedding_ghost_norm  embedding_ghost_norm_sq_cuda  gops.embedding_ghost_norm_sq
    psg_contract          book_weighted_grad_cuda /     cops.book_weighted_grad /
                          psg_contract_grouped_cuda     cops.psg_contract_grouped
    flash_attention       flash_attention_cuda          fops.flash_attention

Resolution order, per call:

1. a ``force_impl`` context override (tests, and ``chip_smoke.py`` running
   the whole step on the plain versions for comparison);
2. an explicit ``impl=`` argument (a tuner ``ClipPlan``'s per-tap
   ``kernels`` map, threaded through the clipping executors);
3. the device default: ``cuda`` for a CUDA tensor, ``torch`` for a CPU one.

The JAX package puts the explicit argument first.  Here the override wins,
so a yardstick run under ``force_impl("torch")`` runs the plain versions
even when a plan records the kernel for every tap.

``available_impls`` is what the tuner may record per tap: the one
production impl of the tensor's device (``cuda`` on the card, ``torch`` on
the CPU).  The plain versions are yardsticks on the card, never a
production choice, so a plan cannot send a card's tap to them (the
executors refuse such a map, ``core/clipping.py``).  The ``block`` sizes
(a plan's ``ghost_block``) tile the plain versions only; the kernels have
their own tiles.

There is no fallback: a CUDA tensor goes to its kernel, which raises if it
cannot build or launch, and ``cuda`` asked for a CPU tensor raises too.
``flash_attention``'s serving form (per-lane ``kv_positions`` or a tensor
``q_offset``) always runs the plain version and counts no launch, as the
JAX package sends it to XLA whatever impl is resolved: the kernel covers
the static masks only.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Mapping, Optional, Sequence, Union

import torch

from repro_torch.core.taps import ConvInfo
from repro_torch.kernels import launches
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ghost_norm import ops as gops
from repro_torch.kernels.psg_contract import ops as cops

OPS = ("ghost_norm", "embedding_ghost_norm", "psg_contract", "flash_attention")
IMPLS = ("cuda", "torch")

# force_impl() state: {op: impl}, consulted per call
_forced: dict[str, str] = {}


def available_impls(x: Union[torch.Tensor, torch.device, str]) -> tuple[str, ...]:
    """The production impls for a tensor's (or a device's) device: the
    kernel on the card, the plain version on the CPU (one each: the tuner
    records it without a race)."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return ("cuda",) if dev.type == "cuda" else ("torch",)


def default_impl(op: str, x: torch.Tensor) -> str:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r}; have {OPS}")
    return "cuda" if x.is_cuda else "torch"


def resolve(op: str, x: torch.Tensor, impl: Optional[str] = None) -> str:
    """Pick the impl for one op: forced > explicit > device default."""
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r}; have {OPS}")
    impl = _forced.get(op, impl)
    if impl is None:
        return default_impl(op, x)
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r} for {op}; have {IMPLS}")
    return impl


@contextlib.contextmanager
def force_impl(impl: Optional[str] = None, **per_op: str) -> Iterator[None]:
    """Override the impl of every op (``impl``) or of single ops (kwargs)."""
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; have {IMPLS}")
    for op, i in per_op.items():
        if op not in OPS:
            raise ValueError(f"unknown kernel op {op!r}; have {OPS}")
        if i not in IMPLS:
            raise ValueError(f"unknown kernel impl {i!r} for {op}; have {IMPLS}")
    saved = dict(_forced)
    try:
        if impl is not None:
            _forced.update({op: impl for op in OPS})
        _forced.update(per_op)
        yield
    finally:
        _forced.clear()
        _forced.update(saved)


def kernels_arg(kernels: Optional[Mapping[str, str]], op: str) -> Optional[str]:
    """The per-tap plan choice for ``op`` (None: no recorded choice)."""
    return None if kernels is None else kernels.get(op)


# -- the dispatched ops ----------------------------------------------------
def ghost_norm_sq(
    a: torch.Tensor, g: torch.Tensor, *, block: int = 512, impl: Optional[str] = None
) -> torch.Tensor:
    """Ghost norm (Eq. 2.7): a (N,T,D), g (N,T,p) -> (N,) fp32."""
    if resolve("ghost_norm", a, impl) == "cuda":
        from repro_torch.kernels.ghost_norm.ghost_norm import ghost_norm_sq_cuda

        return ghost_norm_sq_cuda(a.contiguous(), g.contiguous())
    launches.record("ghost_norm_sq", "torch")
    return gops.ghost_norm_sq(a, g, block=block)


def conv_ghost_norm_sq(
    x: torch.Tensor, g: torch.Tensor, info: ConvInfo, *, block: int = 512,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Ghost norm of a conv tap from its raw input: x (N,H,W,C), g (N,T,p)
    -> (N,) fp32.  The kernel builds the patches on chip; the plain version
    unfolds them.  Both count as ``ghost_norm_sq``."""
    if resolve("ghost_norm", x, impl) == "cuda":
        from repro_torch.kernels.ghost_norm.ghost_norm import conv_ghost_norm_sq_cuda

        return conv_ghost_norm_sq_cuda(x.contiguous(), g.contiguous(), info)
    launches.record("ghost_norm_sq", "torch")
    return gops.conv_ghost_norm_sq(x, g, info, block=block)


def embedding_ghost_norm_sq(
    ids: torch.Tensor, g: torch.Tensor, *, impl: Optional[str] = None
) -> torch.Tensor:
    """Index-equality ghost norm: ids (N,T) int, g (N,T,p) -> (N,) fp32."""
    if resolve("embedding_ghost_norm", g, impl) == "cuda":
        from repro_torch.kernels.ghost_norm.ghost_norm import embedding_ghost_norm_sq_cuda

        return embedding_ghost_norm_sq_cuda(ids.contiguous(), g.contiguous())
    launches.record("embedding_ghost_norm_sq", "torch")
    return gops.embedding_ghost_norm_sq(ids, g)


def book_weighted_grad(
    a: torch.Tensor, g: torch.Tensor, w: torch.Tensor, *, impl: Optional[str] = None
) -> torch.Tensor:
    """Weighted (a,g)-book contraction: sum_r w[m,r] a[m,r]^T g[m,r].

    a (M,R,D), g (M,R,p), w (M,R) -> (M,D,p) fp32.
    """
    if resolve("psg_contract", a, impl) == "cuda":
        from repro_torch.kernels.psg_contract.psg_contract import book_weighted_grad_cuda

        return book_weighted_grad_cuda(
            a.contiguous(), g.contiguous(), w.float().contiguous()
        )
    launches.record("book_weighted_grad", "torch")
    return cops.book_weighted_grad(a, g, w)


def psg_contract_grouped(
    psgs: Sequence[torch.Tensor], c: torch.Tensor, rows: Optional[Sequence[int]] = None, *,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Weighted bank sums of several banks: each psg (N, ...) has the sample
    axis first; returns one fp32 vector holding every bank's
    sum_n c_s[n] * psg[n], flattened, back to back in list order.  ``c`` is
    (N,), shared by every bank, or (G, N) with ``rows[s]`` bank s's row (a
    per-layer-group policy).  One kernel launch on the card (a
    ``psg_contract`` launch), one count on the plain path."""
    flats = [psg if psg.dim() == 2 else psg.reshape(psg.shape[0], -1) for psg in psgs]
    if resolve("psg_contract", c, impl) == "cuda":
        from repro_torch.kernels.psg_contract.psg_contract import psg_contract_grouped_cuda

        return psg_contract_grouped_cuda([x.contiguous() for x in flats],
                                         c.float().contiguous(), rows)
    launches.record("psg_contract", "torch")
    return cops.psg_contract_grouped(flats, c, rows)


def psg_contract(
    psg: torch.Tensor, c: torch.Tensor, *, axis: int = 0, impl: Optional[str] = None
) -> torch.Tensor:
    """Weighted bank sum over the sample axis: sum_n c[n] * psg[..n..], a
    group of one bank.  The result drops ``axis`` and keeps the remaining
    dims in order, fp32."""
    moved = torch.movedim(psg, axis, 0)
    return psg_contract_grouped([moved], c, impl=impl).reshape(moved.shape[1:])


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, K, hd)
    v: torch.Tensor,  # (B, Skv, K, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_positions: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Serving attention forward, (B, Sq, H, hd) in q's dtype.

    The static masks (an int ``q_offset``, no ``kv_positions``) go to the
    resolved impl; the serving form always runs the plain version.
    """
    if kv_positions is not None or not isinstance(q_offset, int):
        return fops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_positions=kv_positions)
    if resolve("flash_attention", q, impl) == "cuda":
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal, window=window, q_offset=q_offset)
    launches.record("flash_attention", "torch")
    return fops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
