"""Per-tap per-sample gradient norms, book-keeping banks, weighted gradients
(port of ``core/ghost.py``).

Given a tap's recorded activation ``a``, its cotangent ``g = dL/ds`` from
the first backward pass, and its ``TapMeta``, this module computes the
per-sample squared gradient norm on the branch the layerwise decision picked
(Alg. 1) and, for book-keeping, the weighted gradient ``sum_i C_i g_i``
directly from the banked residuals, skipping the second backward.

- ``tap_norm_sq``          per-sample norm^2 from (a, g);
- ``tap_bank``             the fused probe's backward payload for one tap
                           (one layer of a stack);
- ``tap_weighted_grads``   ``sum_i C_i g_i`` of one tap from its (a, g)
                           book, every kind (the bk_mixed gradient stage
                           of a ghost-banked tap, and of every tap under
                           ``bk_mixed_taps``);
- ``psg_segments``         a psg-banked tap's per-sample gradients as
                           the segments of the step's one grouped
                           contraction (``dispatch.psg_contract_grouped``).

Canonical layouts (stack dims folded into the row dim N = L * B * G):
matmul a (N, T, D), g (N, T, p); embedding ids (N, T), g (N, T, p); scale
a, g (N, T, p) with grad = sum_T g*a; bias g (N, T, p) with grad = sum_T g.
Per-sample conv gradients are in the parameter's own OIHW layout
(p, d, kh, kw).  The norm, bank and gradient functions take a stacked meta
(``stack_dims = (L,)``) as the JAX package's do: the stack folds into the
per-sample sums, and the book contraction runs once per stacked tap; the
per-sample gradient banks of every psg-banked tap of a step contract in one
grouped call, a stacked tap's layers as separate segments.

The activation and the cotangent reach the ghost-norm kernel in their
stored dtypes (the JAX package upcasts a matmul tap's cotangent to fp32
first; bf16 -> fp32 is exact and the kernel accumulates in fp32, so the norm
is the same); a conv tap's ghost norm reads its raw input and never unfolds
it.  The embedding norm takes the cotangent in its stored dtype too, as the
JAX package does.  The other norms take it in fp32, as in the JAX package.
``dw_conv`` and ``scale_grouped`` arrive with the LM slice.
Autograd saves integer ids, so the JAX package's fp32 id side channel and
its 2^24 vocab guard have no counterpart here.

The tuner's knobs arrive per call, as in the JAX package: ``decision_by``
(Eq. 4.1's space rule or Remark 4.1's time rule), ``override`` (a
``ClipPlan``'s measured branch for this tap; it never wins over a forced
kind or a reference mode, ``decision.decide``), ``ghost_block`` and
``inst_block_d`` (the plain versions' tiles) and ``kernels`` (the plan's
``{op: impl}`` for this tap, ``kernels/dispatch.py``).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.decision import decide
from repro_torch.core.taps import TapMeta
from repro_torch.kernels import dispatch
from repro_torch.kernels.ghost_norm import ops as gops
from repro_torch.nn.conv import conv_padding, pad_nchw, unfold2d

KernelChoices = Optional[Mapping[str, str]]  # {dispatch op: impl} of one tap

_LATER = {"dw_conv": "the LM slice", "scale_grouped": "the LM slice"}


def _unsupported(meta: TapMeta) -> NotImplementedError:
    later = _LATER.get(meta.kind)
    if later is None:
        return NotImplementedError(f"unknown tap kind {meta.kind!r}")
    return NotImplementedError(
        f"tap kind {meta.kind!r} ({meta.param_path}) is ported with {later}"
    )


def _fold(meta: TapMeta, x: torch.Tensor, trailing: tuple[int, ...]) -> torch.Tensor:
    """(stack..., B, <middle>) -> (L, B, *trailing)."""
    return x.reshape((meta.n_stack, meta.batch_size) + trailing)


def _per_sample(meta: TapMeta, rows: torch.Tensor) -> torch.Tensor:
    """(L*B*G,) row norms -> (B,) per-sample sums (over stack and groups)."""
    return rows.reshape(meta.n_stack, meta.batch_size, max(meta.n_groups, 1)).sum(dim=(0, 2))


def _canonical_ag(meta: TapMeta, a: torch.Tensor, g: torch.Tensor):
    """Return a (N, T, D), g (N, T, p) with N = L*B*G."""
    lead = meta.n_stack
    rows = lead * meta.batch_size * max(meta.n_groups, 1)
    gg = g.reshape(rows, meta.T, meta.p)
    if meta.conv is not None:
        # a is the raw (L*B, H, W, d) input: unfold lazily to (N, T, D)
        a4 = a.reshape((lead * meta.batch_size,) + tuple(a.shape[-3:]))
        aa = unfold2d(a4, meta.conv)
    else:
        aa = a.reshape(rows, meta.T, meta.D)
    return aa, gg


def _ghost_rows(meta: TapMeta, a: torch.Tensor, g: torch.Tensor, *, block: int = 512,
                impl: Optional[str] = None) -> torch.Tensor:
    """Ghost norms (N,) of a matmul tap's rows; a conv reads its raw input."""
    if meta.conv is None:
        return dispatch.ghost_norm_sq(*_canonical_ag(meta, a, g), block=block, impl=impl)
    rows = meta.n_stack * meta.batch_size
    x = a.reshape((rows,) + tuple(a.shape[-3:]))
    return dispatch.conv_ghost_norm_sq(x, g.reshape(rows, meta.T, meta.p), meta.conv,
                                       block=block, impl=impl)


def tap_norm_sq(
    meta: TapMeta,
    a: torch.Tensor,
    g: torch.Tensor,
    *,
    mode: str = "mixed_ghost",
    decision_by: str = "space",
    ghost_block: int = 512,
    inst_block_d: int = 8192,
    override: Optional[str] = None,
    kernels: KernelChoices = None,
    include_bias: bool = True,
) -> torch.Tensor:
    """Per-sample squared norm contributions: (B,) fp32 (weight + bias)."""
    b = meta.batch_size
    if meta.kind == "matmul":
        if decide(meta, mode=mode, by=decision_by, override=override) == "ghost":
            rows = _ghost_rows(meta, a, g, block=ghost_block,  # g in its stored dtype
                               impl=dispatch.kernels_arg(kernels, "ghost_norm"))
        else:
            aa, gg = _canonical_ag(meta, a, g.float())
            rows = gops.instantiated_norm_sq(aa, gg, block_d=inst_block_d)
        total = _per_sample(meta, rows)
    elif meta.kind == "embedding":
        n = meta.n_stack * b
        rows = dispatch.embedding_ghost_norm_sq(  # the cotangent in its stored dtype
            a.reshape(n, meta.T), g.reshape(n, meta.T, meta.p),
            impl=dispatch.kernels_arg(kernels, "embedding_ghost_norm"),
        )
        total = _per_sample(meta, rows)
    elif meta.kind in ("scale", "bias"):
        total = _small_psg(meta, a, g).square().sum(dim=(0, 2))
    else:
        raise _unsupported(meta)
    if meta.bias_path is not None and include_bias:
        bias_grad = g.float().reshape(meta.n_stack, b, -1, meta.p).sum(dim=2)
        total = total + bias_grad.square().sum(dim=(0, 2))
    return total


def psg_param_shape(meta: TapMeta) -> tuple[int, ...]:
    """Shape of one sample's banked gradient = the parameter's layout.

    conv (p, d, kh, kw) | dense (D, p) | grouped (G, D, p) | scale, bias (p,).
    """
    if meta.kind == "matmul":
        if meta.conv is not None:
            d_in = meta.D // (meta.conv.kernel[0] * meta.conv.kernel[1])
            return (meta.p, d_in) + tuple(meta.conv.kernel)
        if meta.n_groups > 1:
            return (meta.n_groups, meta.D, meta.p)
        return (meta.D, meta.p)
    if meta.kind in ("scale", "bias"):
        return (meta.p,)
    raise _unsupported(meta)


def _conv_psg(meta: TapMeta, a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-sample conv weight gradients (B, p, d, kh, kw), without im2col.

    dW_b[o, i, u, v] = sum_{y,x} g_b[o, y, x] * xpad_b[i, u + s*y, v + s*x]
    is itself a convolution: the padded input with its batch as channels,
    correlated with each sample's cotangent as a kernel dilated by the
    stride, one group per sample.
    """
    info = meta.conv
    b = meta.batch_size
    kh, kw = info.kernel
    x = a.reshape((b,) + tuple(a.shape[-3:])).float().permute(0, 3, 1, 2)  # (B, d, H, W)
    xp = pad_nchw(x, conv_padding(info.padding, x.shape[2:], info.kernel, info.strides))
    go = g.float().reshape((b,) + tuple(meta.s_shape[-3:])).permute(0, 3, 1, 2)
    ho, wo = go.shape[2:]
    kernel = go.reshape(b * meta.p, 1, ho, wo)
    out = F.conv2d(xp.transpose(0, 1), kernel, dilation=tuple(info.strides), groups=b)
    d_in = x.shape[1]
    out = out[:, :, :kh, :kw].reshape(d_in, b, meta.p, kh, kw)
    return out.permute(1, 2, 0, 3, 4).contiguous()


def _matmul_psg(meta: TapMeta, a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-sample weight gradients (B,) + psg_param_shape(meta)."""
    if meta.conv is not None:
        return _conv_psg(meta, a, g)
    b = meta.batch_size
    gdim = max(meta.n_groups, 1)
    aa = a.float().reshape(b * gdim, meta.T, meta.D)
    gg = g.float().reshape(b * gdim, meta.T, meta.p)
    psg = torch.bmm(aa.transpose(1, 2), gg)
    return psg.reshape((b,) + psg_param_shape(meta))


def _small_psg(meta: TapMeta, a: Optional[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """Per-sample gradients of the small forced-instantiate kinds: (L, B, p)."""
    if meta.kind not in ("scale", "bias"):
        raise _unsupported(meta)
    gf = _fold(meta, g.float(), (meta.T, meta.p))
    if meta.kind == "scale":
        gf = gf * _fold(meta, a.float(), (meta.T, meta.p))
    return gf.sum(dim=-2)


def tap_bank(
    meta: TapMeta,
    a: torch.Tensor,
    g: torch.Tensor,
    *,
    mode: str = "mixed_ghost",
    decision_by: str = "space",
    ghost_block: int = 512,
    inst_block_d: int = 8192,
    override: Optional[str] = None,
    kernels: KernelChoices = None,
) -> dict[str, torch.Tensor]:
    """The fused probe's backward payload for one tap.

    Every bank carries ``n``, the tap's per-sample squared norm (B,).  In
    ``bk_mixed`` it also carries what the weighted-gradient stage needs:
    the per-sample gradients ``psg`` (+ ``psg_b`` for a bias) for
    instantiate-branch and small taps, or the ``(a, g)`` book for
    ghost-branch matmuls and embeddings.  ``meta`` is one layer's (no stack
    dims): the engine stacks a stacked tap's per-layer banks afterwards.
    """
    knobs = dict(decision_by=decision_by, ghost_block=ghost_block,
                 inst_block_d=inst_block_d, kernels=kernels)
    if mode != "bk_mixed":
        return {"n": tap_norm_sq(meta, a, g, mode=mode, override=override, **knobs)}
    b = meta.batch_size
    g32 = g.float()
    bank: dict[str, torch.Tensor] = {}
    if meta.kind == "matmul":
        if decide(meta, mode="bk_mixed", by=decision_by, override=override) == "instantiate":
            psg = _matmul_psg(meta, a, g32)
            bank["psg"] = psg
            n = psg.square().reshape(b, -1).sum(dim=-1)
        else:
            bank["a"], bank["g"] = a, g
            n = tap_norm_sq(meta, a, g, mode="ghost", include_bias=False, **knobs)
    elif meta.kind == "embedding":
        bank["a"], bank["g"] = a, g
        n = tap_norm_sq(meta, a, g, mode="bk_mixed", include_bias=False, **knobs)
    elif meta.kind in ("scale", "bias"):
        psg = _small_psg(meta, a, g32)[0]
        bank["psg"] = psg
        n = psg.square().sum(dim=-1)
    else:
        raise _unsupported(meta)

    if meta.bias_path is not None:
        bias_grad = g32.reshape(b, -1, meta.p).sum(dim=1)
        if "g" not in bank:
            # the book reconstructs the bias grad itself; psg banks keep it
            bank["psg_b"] = bias_grad
        n = n + bias_grad.square().sum(dim=-1)
    bank["n"] = n
    return bank


def _finish_matmul_grad(
    meta: TapMeta, w: torch.Tensor, param_shape: tuple[int, ...]
) -> torch.Tensor:
    """Weighted matmul grad (L*G, D, p) -> the parameter's own layout.

    The unfold's fan-in is channel-major, so a conv's (D, p) gradient is the
    transpose of its OIHW weight flattened to (p, D).
    """
    if meta.conv is not None:
        return w.reshape(meta.n_stack, meta.D, meta.p).transpose(1, 2).reshape(param_shape)
    return w.reshape(param_shape)


def tap_weighted_grads(
    meta: TapMeta,
    a: torch.Tensor,
    g: torch.Tensor,
    clip: torch.Tensor,  # (B,) clip factors C_i
    param_shape: tuple[int, ...],
    kernels: KernelChoices = None,
) -> dict[str, torch.Tensor]:
    """Book-keeping gradients sum_i C_i g_i of one tap from its (a, g) book
    (stack dims leading), every kind.

    A matmul's weight goes through one ``dispatch.book_weighted_grad``
    launch with the layers and groups on its leading dim, M = L*G (the CUDA
    kernel scales cotangent tiles in shared memory, so ``C_i * g_i`` never
    reaches device memory).  An embedding's weighted rows are scatter-added
    by id; a scale (norm gain) or bias tap's weighted cotangent is summed
    over samples and positions, times the recorded ``x_hat`` for a scale.
    Returns {param_path: grad, [bias_path: grad]}.
    """
    if meta.kind not in ("matmul", "embedding", "scale", "bias"):
        raise _unsupported(meta)
    b = meta.batch_size
    lead = meta.n_stack
    gdim = max(meta.n_groups, 1)
    cw = clip.float()
    if meta.kind == "matmul":
        if meta.conv is not None:
            aa = unfold2d(a.reshape((lead * b,) + tuple(a.shape[-3:])), meta.conv)
        else:
            aa = a
        aa = aa.reshape(lead, b, gdim, meta.T, meta.D)
        gg = g.reshape(lead, b, gdim, meta.T, meta.p)
        # canonical (M, R, .) book: rows = (B, T) folded, one weight per row;
        # layer and group instances ride the leading dim
        a2 = aa.transpose(1, 2).reshape(lead * gdim, b * meta.T, meta.D)
        g2 = gg.transpose(1, 2).reshape(lead * gdim, b * meta.T, meta.p)
        w2 = cw[:, None].expand(b, meta.T).reshape(1, b * meta.T).expand(lead * gdim, -1)
        w = dispatch.book_weighted_grad(a2, g2, w2,
                                        impl=dispatch.kernels_arg(kernels, "psg_contract"))
        out = {meta.param_path: _finish_matmul_grad(meta, w, param_shape)}
    else:
        gw = g.float().reshape(lead, b, -1, meta.p) * cw[None, :, None, None]
        if meta.kind == "embedding":
            w = torch.zeros(param_shape, dtype=torch.float32, device=g.device)
            w = w.index_add_(0, a.reshape(-1), gw.reshape(-1, meta.p))
        elif meta.kind == "scale":
            w = (gw * a.float().reshape(gw.shape)).sum(dim=(1, 2)).reshape(param_shape)
        else:
            w = gw.sum(dim=(1, 2)).reshape(param_shape)
        out = {meta.param_path: w}
    if meta.bias_path is not None:
        gb = g.float().reshape(lead, b, -1, meta.p) * cw[None, :, None, None]
        out[meta.bias_path] = gb.sum(dim=(1, 2)).reshape(meta.stack_dims + (meta.p,))
    return out


def psg_segment_sizes(meta: TapMeta) -> list[int]:
    """Columns of a psg-banked tap's contraction segments, in the order
    ``psg_segments`` gives them: one per layer for the weight, then one per
    layer for a bias."""
    sizes = [math.prod(psg_param_shape(meta))] * meta.n_stack
    if meta.bias_path is not None:
        sizes += [meta.p] * meta.n_stack
    return sizes


def psg_segments(
    meta: TapMeta,
    banks: list[dict[str, torch.Tensor]],  # one per layer, in layer order
    param_shape: tuple[int, ...],
) -> list[tuple[str, tuple[int, ...], list[torch.Tensor]]]:
    """A psg-banked tap's part of the book-keeping gradient stage:
    (path, gradient shape, per-layer (B, F) banks) for the weight and for a
    bias.  Contracting each bank with the clip factors along its sample
    axis, layers back to back, gives the gradient in the parameter's own
    layout (the banks are in it already); the banks are reshaped, never
    stacked or copied."""
    b = meta.batch_size
    out = [(meta.param_path, param_shape, [bk["psg"].reshape(b, -1) for bk in banks])]
    if "psg_b" in banks[0]:
        out.append((meta.bias_path, meta.stack_dims + (meta.p,),
                    [bk["psg_b"].reshape(b, -1) for bk in banks]))
    return out
