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
  (``make_zero_taps``, ``tap_specs``) have no counterpart here.

In both engines ``zs`` holds what the first backward differentiates with
respect to: the probes' dummy leaves, or the pre-activations themselves.

Late taps (``late=True``, recurrent weights: the sLSTM's ``wr``) register
their pre-activation before their activation exists: the recurrent input
``h_{t-1}`` comes out of the time loop afterwards and arrives through
``Ctx.record_act``.  A late tap never gets a probe.  Under the fused
engine it takes the explicit channel within the same step, as the JAX
package's fused executor falls back for it: its ``s`` joins ``zs``, so
the first backward gives ``dL/ds`` beside the probes' banks, and its
activation goes to ``late_acts``; the executor norms it (and, in
``bk_mixed``, contracts it) from the explicit ``(a, g)`` and drops its
``s`` from ``zs`` after that backward.  Under the explicit engine a late
tap is an ordinary one whose activation is recorded later.  A tap may also
have no activation at all (``a=None``: the Mamba ``dt_bias`` bias tap,
whose per-sample gradient is the cotangent summed over positions).

Tap names and param paths are the JAX package's (``conv4/out``,
``conv4/w``, ``gn5/g``), so tests compare the two per tap by name.

Layouts follow the JAX package at the tap: convolutions record their raw
NHWC input and NHWC pre-activation; ``a`` and ``g`` of dense and scale taps
are (B, T, width); an embedding records its integer ids (B, T).  Tap kinds
ported: ``matmul`` (dense and conv), ``scale`` (norm gains), each with an
optional bias, ``embedding``, ``bias`` (a bias alone), ``dw_conv`` (a
causal depthwise conv: ``a`` its (B, T, k, d) window, the weight (k, d))
and ``scale_grouped`` (one gain per head of ``dh`` channels: Mamba's
``D``, ``a`` and ``s`` (B, T, h*dh)).  A grouped matmul (the MoE experts,
``n_groups = E``) records a (B, E, C, D) and s (B, E, C, p): each sample's
expert slots are G separate products, whose norms the engine sums.

Stacked layers (``nn/stack.py``'s ``ScannedStack``) run one block per layer
under the same tap names.  The meta is recorded once per name with a
leading stack dim (``TapMeta.with_stack``), and each layer's probe bank,
activation and pre-activation under its own key ``(name, layer)``; the
fused engine sums the norms over the layers and contracts the stacked banks
once per name, the explicit engine stacks a tap's per-layer ``a`` and
``dL/ds`` on a leading dim and norms (and contracts) them once per name.
A rematerialised stack runs each layer's forward again in the backward;
``Ctx.tap`` and ``Ctx.record_act`` keep what the first forward recorded
under a key (the meta it writes again is equal): a late tap's record is
its activation, which outlives the executor's emptying of ``zs``.

On a model axis (tensor and expert parallelism) a rank computes a slice
of a tap: a column-parallel product's outputs, a row-parallel product's
inputs, a vocabulary slice of a table, its experts.  ``TapMeta`` keeps the
tap's full ``D``, ``p`` and ``n_groups``, on which the layerwise decision
(Eq. 4.1) and a tuned plan are taken, so every rank and the one-rank step
pick the same branch, as the JAX package decides on global shapes; its
``local`` holds this rank's ``(D, p, n_groups)``, and ``local_view()`` is
the meta of the tensors the rank holds (``s_shape`` and ``a_shape`` are
recorded from them).  Such a tap's per-sample norm is a partial sum over
the model ranks; a whole tap's is the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

TapKind = str  # "matmul" | "scale" | "embedding" | "bias" | "dw_conv" | "scale_grouped"
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
    a_shape: Optional[tuple[int, ...]] = None  # None: no activation, or a late tap's
    a_dtype: Any = None
    late: bool = False  # the activation arrives through Ctx.record_act
    # this rank's (D, p, n_groups) where the model axis splits the tap
    local: Optional[tuple[int, int, int]] = None

    @property
    def split(self) -> bool:
        """Whether the model axis splits this tap (its norm sums over it)."""
        return self.local is not None

    @property
    def bias_split(self) -> bool:
        """Whether a bias is split with the tap: a column-parallel one (its
        fan-out is local); a row-parallel product's bias is whole."""
        return self.local is not None and self.local[1] != self.p

    def local_view(self) -> "TapMeta":
        """The meta of this rank's slice of the tap: ``D``, ``p`` and
        ``n_groups`` as its tensors hold them."""
        if self.local is None:
            return self
        d, p, groups = self.local
        return dataclasses.replace(self, D=d, p=p, n_groups=groups, local=None)

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
    the vmap oracle runs under, refuses the saved-tensor hooks it needs),
    and has the sLSTM record its time loop op by op (``nn/xlstm.py``).
    ``late_acts`` holds the fused engine's late-tap activations.
    """

    __slots__ = ("meta", "path", "collect", "clip", "zs", "stack", "acts", "remat",
                 "late_acts")

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
        late_acts: Optional[dict[BankKey, torch.Tensor]] = None,
    ):
        self.meta = {} if meta is None else meta
        self.path = path
        self.collect = collect
        self.clip = clip
        self.zs = {} if zs is None else zs
        self.stack = stack
        self.acts = acts
        self.remat = remat
        self.late_acts = {} if late_acts is None else late_acts

    def scope(self, name: str) -> "Ctx":
        return Ctx(self.meta, self._join(name), self.collect, self.clip, self.zs, self.stack,
                   self.acts, self.remat, self.late_acts)

    def layer(self, index: int, n: int) -> "Ctx":
        """The context of layer ``index`` of an ``n``-layer stack (one level:
        the hybrid periods are ``SequentialBlocks`` inside one stack)."""
        if self.stack is not None:
            raise NotImplementedError("nested layer stacks: no model of the registry has one")
        return Ctx(self.meta, self.path, self.collect, self.clip, self.zs, (index, n),
                   self.acts, self.remat, self.late_acts)

    def _join(self, name: str) -> str:
        return f"{self.path}/{name}" if self.path else name

    def _key(self, full: str) -> BankKey:
        return (full, None if self.stack is None else self.stack[0])

    def _records(self, late: bool) -> dict:
        """Where a tap's first-forward record lives: the explicit engine's
        ``acts``, a fused late tap's ``late_acts``, else ``zs``."""
        if self.acts is not None:
            return self.acts
        return self.late_acts if late else self.zs

    def tap(
        self,
        name: str,
        s: torch.Tensor,
        *,
        kind: TapKind,
        a: Optional[torch.Tensor] = None,
        T: int,
        D: int,
        p: int,
        param_path: str,
        bias_path: Optional[str] = None,
        conv: Optional[ConvInfo] = None,
        n_groups: int = 1,
        late: bool = False,
        local: Optional[tuple[int, int, int]] = None,
    ) -> torch.Tensor:
        """Register pre-activation ``s`` with recorded input ``a`` (None for a
        bias tap, and for a late tap, whose ``a`` comes by ``record_act``).
        ``T``, ``D``, ``p`` and ``n_groups`` are the tap's full ones;
        ``local`` this rank's ``(D, p, n_groups)`` where the model axis
        splits it."""
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
            n_groups=n_groups,
            batch_size=int(s.shape[0]),
            a_shape=None if a is None else tuple(int(d) for d in a.shape),
            a_dtype=None if a is None else a.dtype,
            late=late,
            local=local,
        )
        self.meta[full] = meta if self.stack is None else meta.with_stack(self.stack[1])
        key = self._key(full)
        # a rematerialised layer's recomputation (nn/stack.py) calls its taps
        # again: the first forward's records stand (the explicit engine's
        # are its acts, a fused late tap's its late_acts: the executors
        # empty zs after the first backward)
        first = key not in self._records(late)
        if self.acts is not None:  # explicit engine: dL/ds is taken at s itself
            if first:
                if not late:  # a late tap's activation comes by record_act
                    self.acts[key] = None if a is None else a.detach()
                self.zs[key] = s
            return s
        if self.clip is None:
            return s
        if late:  # the explicit channel inside the fused step
            if first:
                self.zs[key] = s
            return s
        from repro_torch.core.fused import probe

        z = torch.zeros((), device=s.device, requires_grad=True)
        if first:
            self.zs[key] = z
        return probe(s, a, z, key, meta, self.clip)

    def record_act(self, name: str, a: torch.Tensor) -> None:
        """The activation of late tap ``name``, once it exists (the recurrent
        input ``h_{t-1}`` of every step, after the time loop).  Discovery
        records nothing, and a recomputation's call leaves the first
        forward's record."""
        if not self.collect or (self.acts is None and self.clip is None):
            return
        store = self._records(late=True)
        key = self._key(self._join(name))
        if key not in store:
            store[key] = a.detach()

    @staticmethod
    def disabled(remat: bool = True) -> "Ctx":
        return Ctx(collect=False, remat=remat)
