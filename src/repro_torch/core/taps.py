"""Taps: where the clipping engine meets the model (port of ``core/taps.py``).

The paper's algorithm needs, for every parameterized linear op
``s = U(a) @ W + b``, the pair ``(a_i, dL/ds_i)`` per sample.  Every such op
hands its pre-activation ``s`` and its input ``a`` to ``Ctx.tap``:

- in discovery mode (``clip=None``, ``acts=None``) the tap only records its
  ``TapMeta``;
- under the fused engine (``clip`` set) ``s`` is routed through an identity
  probe (``core/fused.py``) whose backward computes the tap's per-sample
  norm (and, in book-keeping mode, its bank) from ``a`` and ``dL/ds``;
- under the explicit engine (``acts`` set: the ``*_taps`` reference
  executors) the tap records ``a`` in ``acts`` and keeps ``s`` itself in
  ``zs``.  The engine's first ``torch.autograd.grad`` is taken with respect
  to those ``s`` tensors, which gives ``dL/ds`` per tap: PyTorch's own
  idiom, so the JAX package's zero taps added to every pre-activation
  (``make_zero_taps``, ``tap_specs``) have no counterpart here.  Late taps
  (``late=True``, ``record_act``: recurrent LM weights) come with the LM
  slice.

In both engines ``zs`` holds what the first backward differentiates with
respect to: the probes' dummy leaves, or the pre-activations themselves.

Tap names and param paths are the JAX package's (``conv4/out``,
``conv4/w``, ``gn5/g``), so tests compare the two per tap by name.

Layouts follow the JAX package at the tap: convolutions record their raw
NHWC input and NHWC pre-activation; ``a`` and ``g`` of dense and scale taps
are (B, T, width); an embedding records its integer ids (B, T).  Tap kinds
in this slice: ``matmul`` (dense and conv), ``scale`` (norm gains), each
with an optional bias, and ``embedding``.

Stacked layers (``nn/stack.py``'s ``ScannedStack``) run one block per layer
under the same tap names.  The meta is recorded once per name with a
leading stack dim (``TapMeta.with_stack``), and each layer's probe bank,
activation and pre-activation under its own key ``(name, layer)``; the
fused engine sums the norms over the layers and contracts the stacked banks
once per name, the explicit engine stacks a tap's per-layer ``a`` and
``dL/ds`` on a leading dim and norms (and contracts) them once per name.
A rematerialised stack runs each layer's forward again in the backward;
``Ctx.tap`` keeps what the first forward recorded under a key (the meta it
writes again is equal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

TapKind = str  # "matmul" | "scale" | "embedding"
BankKey = tuple[str, Optional[int]]  # (tap name, layer index; None unstacked)


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
    stack_dims: tuple[int, ...] = ()  # leading dims added by ScannedStack
    conv: Optional[ConvInfo] = None
    batch_size: int = 0
    a_shape: Optional[tuple[int, ...]] = None
    a_dtype: Any = None

    def with_stack(self, n: int) -> "TapMeta":
        """The meta of ``n`` stacked copies of this tap."""
        return dataclasses.replace(
            self,
            stack_dims=(n,) + self.stack_dims,
            s_shape=(n,) + tuple(self.s_shape),
            a_shape=(n,) + tuple(self.a_shape) if self.a_shape is not None else None,
        )

    @property
    def n_stack(self) -> int:
        out = 1
        for s in self.stack_dims:
            out *= s
        return out


def bank_keys(name: str, meta: TapMeta) -> list[BankKey]:
    """The keys tap ``name`` banks under: one per layer when stacked."""
    if not meta.stack_dims:
        return [(name, None)]
    return [(name, layer) for layer in range(meta.n_stack)]


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
    banks: dict[BankKey, dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)
    # the step's branch knobs (``ClipConfig``) and, once the forward has
    # named the taps, a plan's per-tap branch overrides and kernel choices
    decision_by: str = "space"
    ghost_block: int = 512
    inst_block_d: int = 8192
    overrides: dict[str, str] = dataclasses.field(default_factory=dict)
    kernels: dict[str, dict[str, str]] = dataclasses.field(default_factory=dict)

    def tap_args(self, name: str) -> dict:
        """``ghost.tap_bank``'s keyword arguments for tap ``name``."""
        return dict(mode=self.mode, decision_by=self.decision_by,
                    ghost_block=self.ghost_block, inst_block_d=self.inst_block_d,
                    override=self.overrides.get(name), kernels=self.kernels.get(name))


class Ctx:
    """Per-forward context threading taps in and tap metadata out.

    ``clip=None`` is discovery mode (meta only); ``collect=False`` disables
    DP bookkeeping entirely (the non-private step).  Under the fused engine
    each tap adds one 0-dim dummy leaf to ``zs``: the first backward asks
    autograd for the gradients of those leaves only, which runs every probe
    and prunes every parameter-gradient kernel.  ``stack`` is set inside a
    ``ScannedStack``: (this layer's index, the number of layers).  ``acts``
    set (and ``clip`` None) is the explicit engine: each tap records its
    input there and its pre-activation in ``zs``.  ``remat=False`` turns off
    the stacks' rematerialisation for this forward (``torch.func``, which
    the vmap oracle runs under, refuses the saved-tensor hooks it needs).
    """

    __slots__ = ("meta", "path", "collect", "clip", "zs", "stack", "acts", "remat")

    def __init__(
        self,
        meta: Optional[dict[str, TapMeta]] = None,
        path: str = "",
        collect: bool = True,
        clip: Optional[ClipRuntime] = None,
        zs: Optional[dict[BankKey, torch.Tensor]] = None,
        stack: Optional[tuple[int, int]] = None,
        acts: Optional[dict[BankKey, torch.Tensor]] = None,
        remat: bool = True,
    ):
        self.meta = {} if meta is None else meta
        self.path = path
        self.collect = collect
        self.clip = clip
        self.zs = {} if zs is None else zs
        self.stack = stack
        self.acts = acts
        self.remat = remat

    def scope(self, name: str) -> "Ctx":
        return Ctx(self.meta, self._join(name), self.collect, self.clip, self.zs, self.stack,
                   self.acts, self.remat)

    def layer(self, index: int, n: int) -> "Ctx":
        """The context of layer ``index`` of an ``n``-layer stack."""
        if self.stack is not None:
            raise NotImplementedError("nested layer stacks come with the LM slice")
        return Ctx(self.meta, self.path, self.collect, self.clip, self.zs, (index, n),
                   self.acts, self.remat)

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
        if self.stack is None:
            self.meta[full] = meta
            key: BankKey = (full, None)
        else:
            index, n = self.stack
            self.meta[full] = meta.with_stack(n)
            key = (full, index)
        # a rematerialised layer's recomputation (nn/stack.py) calls its taps
        # again: the first forward's records stand
        first = key not in self.zs
        if self.acts is not None:  # explicit engine: dL/ds is taken at s itself
            if first:
                self.acts[key] = a.detach()
                self.zs[key] = s
            return s
        if self.clip is None:
            return s
        from repro_torch.core.fused import probe

        z = torch.zeros((), device=s.device, requires_grad=True)
        if first:
            self.zs[key] = z
        return probe(s, a, z, key, meta, self.clip)

    @staticmethod
    def disabled(remat: bool = True) -> "Ctx":
        return Ctx(collect=False, remat=remat)
