"""Taps: where the clipping engine meets the model (port of ``core/taps.py``).

The paper's algorithm needs, for every parameterized linear op
``s = U(a) @ W + b``, the pair ``(a_i, dL/ds_i)`` per sample.  Every such op
hands its pre-activation ``s`` and its input ``a`` to ``Ctx.tap``:

- in discovery mode (``clip=None``) the tap only records its ``TapMeta``;
- under the fused engine (``clip`` set) ``s`` is routed through an identity
  probe (``core/fused.py``) whose backward computes the tap's per-sample
  norm (and, in book-keeping mode, its bank) from ``a`` and ``dL/ds``.

Tap names and param paths are the JAX package's (``conv4/out``,
``conv4/w``, ``gn5/g``), so tests compare the two per tap by name.

Layouts follow the JAX package at the tap: convolutions record their raw
NHWC input and NHWC pre-activation; ``a`` and ``g`` of dense and scale taps
are (B, T, width).  Tap kinds in this slice: ``matmul`` (dense and conv)
and ``scale`` (norm gains), each with an optional bias.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

TapKind = str  # "matmul" | "scale"


@dataclasses.dataclass(frozen=True)
class ConvInfo:
    """Unfold (im2col) parameters for convolution taps."""

    kernel: tuple[int, ...]  # (kh, kw)
    strides: tuple[int, ...]
    padding: Any  # "SAME" | "VALID" | ((lo, hi), (lo, hi))


@dataclasses.dataclass(frozen=True)
class TapMeta:
    """Static metadata for one tap."""

    kind: TapKind
    T: int  # positions per sample (H_out*W_out for conv, seq len for dense)
    D: int  # fan-in = d * prod(kernel)
    p: int  # fan-out
    s_shape: tuple[int, ...]  # full shape of the tapped pre-activation
    s_dtype: Any
    param_path: str  # param-tree path ("a/b/w") of the weight for this tap
    bias_path: Optional[str] = None  # set when the op has a bias param
    n_groups: int = 1
    stack_dims: tuple[int, ...] = ()  # stacked layers arrive with the ViT/LM slices
    conv: Optional[ConvInfo] = None
    batch_size: int = 0
    a_shape: Optional[tuple[int, ...]] = None
    a_dtype: Any = None

    @property
    def n_stack(self) -> int:
        out = 1
        for s in self.stack_dims:
            out *= s
        return out


@dataclasses.dataclass
class ClipRuntime:
    """What the fused probes read in their backward, for one step.

    ``mode`` is fixed for the step.  ``phase`` and ``banks`` change within
    it: in the first backward (``phase == "bank"``) every probe writes its
    bank into ``banks``; in the second backward of the second-backward
    modes (``phase == "grad"``) the probes pass the cotangent through and
    compute nothing, so a step computes each norm once.
    """

    mode: str = "mixed_ghost"
    phase: str = "bank"
    banks: dict[str, dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)


class Ctx:
    """Per-forward context threading taps in and tap metadata out.

    ``clip=None`` is discovery mode (meta only); ``collect=False`` disables
    DP bookkeeping entirely (the non-private step).  Under the fused engine
    each tap adds one 0-dim dummy leaf to ``zs``: the first backward asks
    autograd for the gradients of those leaves only, which runs every probe
    and prunes every parameter-gradient kernel.
    """

    __slots__ = ("meta", "path", "collect", "clip", "zs")

    def __init__(
        self,
        meta: Optional[dict[str, TapMeta]] = None,
        path: str = "",
        collect: bool = True,
        clip: Optional[ClipRuntime] = None,
        zs: Optional[dict[str, torch.Tensor]] = None,
    ):
        self.meta = {} if meta is None else meta
        self.path = path
        self.collect = collect
        self.clip = clip
        self.zs = {} if zs is None else zs

    def scope(self, name: str) -> "Ctx":
        return Ctx(self.meta, self._join(name), self.collect, self.clip, self.zs)

    def _join(self, name: str) -> str:
        return f"{self.path}/{name}" if self.path else name

    def tap(
        self,
        name: str,
        s: torch.Tensor,
        *,
        kind: TapKind,
        a: torch.Tensor,
        T: int,
        D: int,
        p: int,
        param_path: str,
        bias_path: Optional[str] = None,
        conv: Optional[ConvInfo] = None,
    ) -> torch.Tensor:
        """Register pre-activation ``s`` with recorded input ``a``."""
        if not self.collect:
            return s
        full = self._join(name)
        meta = TapMeta(
            kind=kind,
            T=T,
            D=D,
            p=p,
            s_shape=tuple(int(d) for d in s.shape),
            s_dtype=s.dtype,
            param_path=self._join(param_path),
            bias_path=self._join(bias_path) if bias_path else None,
            conv=conv,
            batch_size=int(s.shape[0]),
            a_shape=tuple(int(d) for d in a.shape),
            a_dtype=a.dtype,
        )
        self.meta[full] = meta
        if self.clip is None:
            return s
        from repro_torch.core.fused import probe

        z = torch.zeros((), device=s.device, requires_grad=True)
        self.zs[full] = z
        return probe(s, a, z, full, meta, self.clip)

    @staticmethod
    def disabled() -> "Ctx":
        return Ctx(collect=False)
