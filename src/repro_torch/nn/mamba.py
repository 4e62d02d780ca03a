"""Mamba block, SSD (Mamba-2) form with a scalar decay per head (port of
``nn/mamba.py``).

The JAX package replaces the Mamba-1 selective scan by the SSD formulation,
whose chunked form is matrix products (``nn/ssm_scan.chunked_ssm``); the
port keeps it.  Every trainable parameter enters through a tap:

- ``in_z`` / ``in_x`` / ``in_bcdt`` / ``out_proj``: matmul taps (``Dense``);
- ``conv``: the ``dw_conv`` tap of the causal depthwise conv;
- ``dt_bias``: a bias tap on the dt stream (no activation);
- ``A_log``: a scale tap on the decay stream, whose activation is the
  decay log itself (d log_a / d A_log = log_a);
- ``D``: a ``scale_grouped`` tap on the skip stream (one gain per head of
  ``head_dim`` channels),

so per-sample clipping covers the whole block exactly.

On a model axis the heads split, as the JAX package's placements and its
``shard_heads`` constraint put them: ``in_z`` and ``in_x`` are
column-parallel (this rank's H/model heads of channels), the depthwise conv
runs on those channels, ``out_proj`` is row-parallel.  ``in_bcdt`` is
whole, and its B and C columns feed every local head, so each rank's
cotangent of them is a partial sum: ``copy_to_model`` completes it before
the tap, whose norm is then counted once.  The dt stream stays whole
through its ``dt_bias`` and ``A_log`` taps; ``shard_heads`` then keeps this
rank's heads of the decay and the step size, and its backward completes the
stream's cotangent.  ``D`` (whole) enters as this rank's slice
(``reshard.slice_whole``) on a split ``scale_grouped`` tap, and the
``RMSNorm`` over ``d_inner`` sums its squares over the ranks; ``chunked_ssm``
runs on the local heads unchanged.
With a cache (serving) the block reads its conv and SSM states and writes
the new ones into the cache it is given, in place, as the attention block
writes its KV rows: one token goes through ``ssm_decode_step``, a prompt
through ``chunked_ssm`` from the carried state.  On a model axis the cache
holds this rank's part: the SSM state (B, H / model, ds, dh) of its heads,
as the JAX placement splits it, and the conv state (B, k - 1, d_inner /
model) of its channels, where the JAX placement keeps it whole (a
divergence by design: the depthwise conv runs on the rank's channels, so
the whole state would only be sliced, and gathered back to be written).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.nn.conv import DepthwiseConv1d
from repro_torch.nn.module import AxesTree, Dense, Module, Params, RMSNorm, at_least_fp32
from repro_torch.nn.ssm_scan import chunked_ssm, ssm_decode_step
from repro_torch.parallel import collectives, reshard
from repro_torch.parallel.reshard import shard_heads


class MambaBlock(Module):
    def __init__(
        self, name: str, d_model: int, *, expand: int = 2, head_dim: int = 64,
        d_state: int = 64, conv_k: int = 4, chunk: int = 256, dtype=torch.float32,
        param_dtype=torch.float32, device: torch.device,
    ):
        self.name = name
        self.d_model = d_model
        self.d_inner = expand * d_model
        if self.d_inner % head_dim:
            raise ValueError(f"{name}: d_inner {self.d_inner} not a multiple of {head_dim}")
        self.n_heads = self.d_inner // head_dim
        self.head_dim = head_dim
        self.d_state = d_state
        self.conv_k = conv_k
        self.chunk = chunk
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.device = device
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        # separate projections: z (d_inner), x (d_inner), B, C and dt (2 * d_state + H)
        self.in_z = Dense(f"{name}.in_z", d_model, self.d_inner, use_bias=False,
                          w_axes=("embed", "mlp"), **common)
        self.in_x = Dense(f"{name}.in_x", d_model, self.d_inner, use_bias=False,
                          w_axes=("embed", "mlp"), **common)
        self.in_bcdt = Dense(f"{name}.in_bcdt", d_model, 2 * d_state + self.n_heads,
                             use_bias=False, w_axes=("embed", None), **common)
        self.conv = DepthwiseConv1d(f"{name}.conv", self.d_inner, conv_k, use_bias=True,
                                    **common)
        self.norm = RMSNorm(f"{name}.norm", self.d_inner, **common)
        self.out_proj = Dense(f"{name}.out_proj", self.d_inner, d_model, use_bias=False,
                              w_axes=("mlp", "embed"), **common)

    def init(self, generator: torch.Generator) -> Params:
        h, dev = self.n_heads, self.device
        # dt bias: the inverse softplus of dt log-uniform in [1e-3, 1e-1]
        u = torch.rand((h,), generator=generator, device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        return {
            "in_z": self.in_z.init(generator),
            "in_x": self.in_x.init(generator),
            "in_bcdt": self.in_bcdt.init(generator),
            "conv": self.conv.init(generator),
            "out_proj": self.out_proj.init(generator),
            "norm": self.norm.init(generator),
            "dt_bias": dt_bias.to(self.param_dtype),
            "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).to(self.param_dtype),
            "D": torch.ones((h,), dtype=self.param_dtype, device=dev),
        }

    def axes(self) -> AxesTree:
        return {
            "in_z": self.in_z.axes(),
            "in_x": self.in_x.axes(),
            "in_bcdt": self.in_bcdt.axes(),
            "conv": self.conv.axes(),
            "out_proj": self.out_proj.axes(),
            "norm": self.norm.axes(),
            "dt_bias": (None,),
            "A_log": (None,),
            "D": (None,),
        }

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None):
        """Without ``cache`` returns y; with it, (y, cache) after writing the
        new conv and SSM states into ``cache`` in place."""
        bsz, t, _ = x.shape
        h, dh, ds = self.n_heads, self.head_dim, self.d_state
        z = self.in_z(params["in_z"], x, ctx.scope("in_z"))
        xs = self.in_x(params["in_x"], x, ctx.scope("in_x"))
        bcdt = self.in_bcdt(params["in_bcdt"], x, ctx.scope("in_bcdt"))
        b_in, c_in, dt = bcdt[..., :ds], bcdt[..., ds:2 * ds], bcdt[..., 2 * ds:]
        hl = xs.shape[-1] // dh  # this rank's heads
        split = hl != h
        if split:
            if h % reshard.model_size():
                raise ValueError(f"{self.name}: {h} heads do not divide over the model axis "
                                 f"of {reshard.model_size()} (a head would split)")
            group = reshard.model_group()
            b_in, c_in = collectives.copy_to_model(b_in, group), collectives.copy_to_model(
                c_in, group)

        if cache is not None and cache["ssm"].shape[1] != hl:
            raise ValueError(f"{self.name}: a serve state of {cache['ssm'].shape[1]} heads, "
                             f"this rank runs {hl} (parallel.sharding.local_serve_shardings)")
        xs, conv_state = self.conv(params["conv"], xs, ctx.scope("conv"),
                                   state=None if cache is None else cache["conv"])
        xs = F.silu(xs)

        dt = dt + params["dt_bias"].to(dt.dtype)  # the dt stream, with its bias tap
        if ctx.collect:
            dt = ctx.tap("dt_bias@out", dt, kind="bias", T=t, D=1, p=h, param_path="dt_bias")
        delta = F.softplus(at_least_fp32(dt))  # (B, T, H)

        # the decay stream: log_a = -exp(A_log) * delta, d(log_a)/d(A_log) = log_a
        log_a = -torch.exp(params["A_log"].to(delta.dtype)) * delta
        if ctx.collect:
            log_a = ctx.tap("A_log@out", log_a, kind="scale", a=log_a, T=t, D=h, p=h,
                            param_path="A_log")
        if split:  # this rank's heads of the whole streams
            delta, log_a = shard_heads(delta), shard_heads(log_a)

        v = xs.reshape(bsz, t, hl, dh) * delta[..., None].to(xs.dtype)
        q = c_in[:, :, None, :].expand(bsz, t, hl, ds)  # B and C are shared by the heads
        k = b_in[:, :, None, :].expand(bsz, t, hl, ds)
        if cache is not None and t == 1:
            y, ssm_state = ssm_decode_step(q, k, v, log_a, cache["ssm"])
        else:
            y, ssm_state = chunked_ssm(q, k, v, log_a, chunk=self.chunk,
                                       state0=None if cache is None else cache["ssm"])
        y = y.reshape(bsz, t, hl * dh)

        # the D skip: one gain per head (a scale_grouped tap, a = xs)
        d_skip = reshard.slice_whole(params["D"], 0) if split else params["D"]
        skip = xs * d_skip.to(xs.dtype).repeat_interleave(dh)
        if ctx.collect:
            skip = ctx.tap("D@out", skip, kind="scale_grouped", a=xs, T=t, D=dh, p=h,
                           param_path="D", local=(dh, hl, 1) if split else None)
        y = (y + skip) * F.silu(z)
        y = self.norm(params["norm"], y, ctx.scope("norm"))
        out = self.out_proj(params["out_proj"], y, ctx.scope("out_proj"))
        if cache is None:
            return out
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(ssm_state)
        return out, cache

    def init_cache(self, batch: int, dtype: torch.dtype) -> dict:
        return {
            "conv": torch.zeros((batch, self.conv_k - 1, self.d_inner), dtype=dtype,
                                device=self.device),
            "ssm": torch.zeros((batch, self.n_heads, self.d_state, self.head_dim),
                               dtype=torch.float32, device=self.device),
        }
