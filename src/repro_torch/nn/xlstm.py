"""xLSTM blocks: mLSTM (parallelisable matrix memory) and sLSTM (sequential),
port of ``nn/xlstm.py``.

The JAX package's variant, kept here:

- mLSTM: a sigmoid input gate folded into k and a log-sigmoid forget gate as
  the scalar decay of ``chunked_ssm`` (the bounded-gate variant of the
  paper's exponential gating: no running max-stabiliser, decays in
  (0, 1]).  The normaliser n_t rides as an extra column of v (the input
  gate), so the state is (B, H, dh, dh + 1), and the output is
  num / max(|den|, 1).
- sLSTM: the exponential input gate with the max-stabiliser, and a full
  recurrent matrix ``wr``.  Its time loop is a Python loop over T here
  (``lax.scan`` in the JAX package), about twenty small launches a token.
  ``wr`` is clipped per sample through a late tap on the input stream
  ``pre`` (the loop adds ``h_{t-1} @ wr`` to ``pre_t``, so dL/dpre_t is
  dL/ds_t); its activation, ``h_{t-1}`` for every t, exists only after the
  loop and is recorded then (``Ctx.record_act``).

The loop is one autograd node in training (``SLSTMScan``): its forward
runs without recording and keeps each step's carry and gate values in a
few stacked tensors; its backward walks the steps in reverse with the
derivatives autograd takes of the cell, then forms dL/dwr = sum_t h_{t-1}^T
dL/ds_t as one product.  Recorded op by op, the loop saves ~50 tensors a
token, and under a rematerialised stack each of them passes through the
checkpoint's Python hooks: on an H100 80GB HBM3 at 700 W that made a
24-layer xLSTM-350M step at 4 x 2048 tokens take 20 s.  The function and
its derivatives are the recorded loop's (``slstm_scan``).  ``torch.func``
runs no ``autograd.Function`` without ``setup_context`` and a vmap rule,
so the vmap oracle (``Ctx.remat`` False) records the loop op by op.

With a cache (serving) each block reads its states and writes the new ones
into the cache in place: the conv state, the mLSTM's matrix memory, the
sLSTM's ``h`` (compute dtype) and ``c``, ``n``, ``m`` (fp32; ``m`` starts at
-1e30).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.taps import Ctx
from repro_torch.nn.conv import DepthwiseConv1d
from repro_torch.nn.mlp import GatedMLP
from repro_torch.nn.module import AxesTree, Dense, Module, Params, RMSNorm
from repro_torch.nn.ssm_scan import chunked_ssm, ssm_decode_step
from repro_torch.parallel.reshard import reshard_param

M_INIT = -1e30  # the sLSTM stabiliser's start: exp(m_prev - m) is 0 at the first step


def _cell(s: torch.Tensor, c, n, m, dtype):
    """One sLSTM step from s = pre_t + h_{t-1} @ wr: (h, c, n, m) and the
    fp32 values its derivative reads (gates, stabilised factors)."""
    zi, fo, ii, oo = s.float().chunk(4, dim=-1)
    log_f = F.logsigmoid(fo)
    lfm = log_f + m
    m_new = torch.maximum(lfm, ii)
    i_p = torch.exp(ii - m_new)
    f_p = torch.exp(lfm - m_new)
    z = torch.tanh(zi)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    o = torch.sigmoid(oo)
    q = torch.clamp(n, min=1e-6)
    r = c / q
    return (o * r).to(dtype), c, n, m_new, (fo, ii, lfm, i_p, f_p, z, o, q, r)


def slstm_scan(pre: torch.Tensor, h, c, n, m, wr: torch.Tensor):
    """The sLSTM time loop over ``pre`` (B, T, 4d) from the carry (h, c, n, m):
    (h_prev (B, T, d), h, c, n, m) with h_prev[:, t] = h_{t-1}."""
    hs = []  # hs[t] = h_{t-1}, the recurrent input of step t
    for pre_t in pre.unbind(1):  # one backward node for the whole stream
        hs.append(h)
        h, c, n, m, _ = _cell(pre_t + h @ wr, c, n, m, pre.dtype)
    return torch.stack(hs, dim=1), h, c, n, m


class SLSTMScan(torch.autograd.Function):
    """``slstm_scan`` as one autograd node (see the module docstring): the
    forward keeps every step's carry (c, n) and its gate values stacked
    over time, and the backward walks the steps in reverse with the
    derivatives autograd takes of ``_cell`` (``torch.maximum`` splits a
    tie's gradient in half), then dL/dwr = sum_t h_{t-1}^T dL/ds_t as one
    product."""

    @staticmethod
    def forward(ctx, pre, h, c, n, m, wr):
        carry, aux, hs = [(c, n)], [], []
        for pre_t in pre.unbind(1):
            hs.append(h)
            h, c, n, m, step = _cell(pre_t + h @ wr, c, n, m, pre.dtype)
            carry.append((c, n))
            aux.append(step)
        h_prev = torch.stack(hs, dim=1)
        cs, ns = (torch.stack(x, dim=1) for x in zip(*carry))  # (B, T + 1, d)
        ctx.save_for_backward(h_prev, cs, ns, wr, *(torch.stack(x, dim=1) for x in zip(*aux)))
        return h_prev, h, c, n, m

    @staticmethod
    def backward(ctx, g_hs, g_h, g_c, g_n, g_m):
        h_prev, cs, ns, wr, *aux = ctx.saved_tensors
        t_len, d = h_prev.shape[1], wr.shape[0]
        dtype = h_prev.dtype
        g_h = g_h.float()
        g_c, g_n, g_m = g_c.float(), g_n.float(), g_m.float()
        wr_t = wr.mT
        g_s = [None] * t_len
        for t in range(t_len - 1, -1, -1):
            c0, n0, c1, n1 = cs[:, t], ns[:, t], cs[:, t + 1], ns[:, t + 1]
            fo, ii, lfm, i_p, f_p, z, o, q, r = (x[:, t] for x in aux)
            g_o = g_h * r
            g_r = g_h * o
            g_c1 = g_c + g_r / q
            g_n1 = g_n + (-g_r * (r / q)) * (n1 >= 1e-6)
            g_fp = g_c1 * c0 + g_n1 * n0
            g_ip = g_c1 * z + g_n1
            g_zi = g_c1 * i_p * (1 - z * z)
            g_x_f = g_fp * f_p  # d/d(lfm - m_new)
            g_x_i = g_ip * i_p  # d/d(ii - m_new)
            g_mn = g_m - g_x_f - g_x_i
            tie = lfm == ii
            g_lfm = g_x_f + torch.where(tie, g_mn / 2, g_mn * (lfm > ii))
            g_ii = g_x_i + torch.where(tie, g_mn / 2, g_mn * (ii > lfm))
            g_fo = g_lfm * torch.sigmoid(-fo)
            g_oo = g_o * o * (1 - o)
            gs_t = torch.cat([g_zi, g_fo, g_ii, g_oo], dim=-1).to(dtype)
            g_s[t] = gs_t
            g_c, g_n, g_m = g_c1 * f_p, g_n1 * f_p, g_lfm
            g_h = (g_hs[:, t] + gs_t @ wr_t).float()
        g_pre = torch.stack(g_s, dim=1)
        g_wr = (h_prev.reshape(-1, d).mT @ g_pre.reshape(-1, 4 * d)).to(wr.dtype)
        return g_pre, g_h.to(h_prev.dtype), g_c, g_n, g_m, g_wr


class MLSTMBlock(Module):
    """Pre-norm mLSTM block with its internal up and down projections."""

    def __init__(
        self, name: str, d_model: int, n_heads: int, *, expand: int = 2, conv_k: int = 4,
        chunk: int = 256, dtype=torch.float32, param_dtype=torch.float32,
        device: torch.device,
    ):
        self.name = name
        self.d_model = d_model
        self.d_inner = expand * d_model
        self.n_heads = n_heads
        if self.d_inner % n_heads:
            raise ValueError(f"{name}: d_inner {self.d_inner} not a multiple of {n_heads}")
        self.head_dim = self.d_inner // n_heads
        self.conv_k = conv_k
        self.chunk = chunk
        self.dtype = dtype
        self.device = device
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        di = self.d_inner
        self.norm = RMSNorm(f"{name}.norm", d_model, **common)
        self.in_x = Dense(f"{name}.in_x", d_model, di, use_bias=False,
                          w_axes=("embed", "mlp"), **common)
        self.in_z = Dense(f"{name}.in_z", d_model, di, use_bias=False,
                          w_axes=("embed", "mlp"), **common)
        self.conv = DepthwiseConv1d(f"{name}.conv", di, conv_k, **common)
        self.wq = Dense(f"{name}.q", di, di, use_bias=False, w_axes=("mlp", "heads"), **common)
        self.wk = Dense(f"{name}.k", di, di, use_bias=False, w_axes=("mlp", "heads"), **common)
        self.gates = Dense(f"{name}.gates", di, 2 * n_heads, use_bias=True,
                           w_axes=("mlp", None), **common)
        self.out_norm = RMSNorm(f"{name}.out_norm", di, **common)
        self.out_proj = Dense(f"{name}.out_proj", di, d_model, use_bias=False,
                              w_axes=("mlp", "embed"), **common)

    def init(self, generator: torch.Generator) -> Params:
        p = {
            "norm": self.norm.init(generator),
            "in_x": self.in_x.init(generator),
            "in_z": self.in_z.init(generator),
            "conv": self.conv.init(generator),
            "q": self.wq.init(generator),
            "k": self.wk.init(generator),
            "gates": self.gates.init(generator),
            "out_norm": self.out_norm.init(generator),
            "out_proj": self.out_proj.init(generator),
        }
        p["gates"]["b"][self.n_heads:] = 3.0  # forget-gate bias: long memory at init
        return p

    def axes(self) -> AxesTree:
        return {
            "norm": self.norm.axes(),
            "in_x": self.in_x.axes(),
            "in_z": self.in_z.axes(),
            "conv": self.conv.axes(),
            "q": self.wq.axes(),
            "k": self.wk.axes(),
            "gates": self.gates.axes(),
            "out_norm": self.out_norm.axes(),
            "out_proj": self.out_proj.axes(),
        }

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None):
        """Without ``cache`` returns the block's output; with it, (output,
        cache) after writing the new states into ``cache`` in place."""
        bsz, t, _ = x.shape
        h, dh = self.n_heads, self.head_dim
        res = x
        x = self.norm(params["norm"], x, ctx.scope("norm"))
        xi = self.in_x(params["in_x"], x, ctx.scope("in_x"))
        z = self.in_z(params["in_z"], x, ctx.scope("in_z"))
        xc, conv_state = self.conv(params["conv"], xi, ctx.scope("conv"),
                                   state=None if cache is None else cache["conv"])
        xc = F.silu(xc)

        q = self.wq(params["q"], xc, ctx.scope("q")).reshape(bsz, t, h, dh)
        k = self.wk(params["k"], xc, ctx.scope("k")).reshape(bsz, t, h, dh) * dh**-0.5
        v = xi.reshape(bsz, t, h, dh)
        g = self.gates(params["gates"], xc, ctx.scope("gates"))  # (B, T, 2H)
        i_gate = torch.sigmoid(g[..., :h].float())
        log_f = F.logsigmoid(g[..., h:].float())

        k = k * i_gate[..., None].to(k.dtype)
        v_ext = torch.cat([v, i_gate[..., None].to(v.dtype)], dim=-1)  # the normaliser column
        if cache is not None and t == 1:
            y_ext, ssm_state = ssm_decode_step(q, k, v_ext, log_f, cache["ssm"])
        else:
            y_ext, ssm_state = chunked_ssm(q, k, v_ext, log_f, chunk=self.chunk,
                                           state0=None if cache is None else cache["ssm"])
        y = y_ext[..., :dh] / torch.clamp(y_ext[..., dh].abs(), min=1.0)[..., None]
        y = self.out_norm(params["out_norm"], y.reshape(bsz, t, self.d_inner),
                          ctx.scope("out_norm"))
        y = y * F.silu(z)
        out = res + self.out_proj(params["out_proj"], y, ctx.scope("out_proj"))
        if cache is None:
            return out
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(ssm_state)
        return out, cache

    def init_cache(self, batch: int, dtype: torch.dtype) -> dict:
        return {
            "conv": torch.zeros((batch, self.conv_k - 1, self.d_inner), dtype=dtype,
                                device=self.device),
            "ssm": torch.zeros((batch, self.n_heads, self.head_dim, self.head_dim + 1),
                               dtype=torch.float32, device=self.device),
        }


class SLSTMBlock(Module):
    """Pre-norm sLSTM with a full recurrent matrix, then a gated FFN (4/3)."""

    def __init__(
        self, name: str, d_model: int, n_heads: int, *, conv_k: int = 4,
        ffn_factor: float = 4.0 / 3.0, dtype=torch.float32, param_dtype=torch.float32,
        device: torch.device,
    ):
        self.name = name
        self.d_model = d_model
        self.n_heads = n_heads
        self.conv_k = conv_k
        self.dtype = dtype
        self.device = device
        # a 64-multiple, as the JAX package rounds it for its 16-way "mlp" axis
        d_ff = max(64, int(round(ffn_factor * d_model / 64) * 64))
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm = RMSNorm(f"{name}.norm", d_model, **common)
        self.conv = DepthwiseConv1d(f"{name}.conv", d_model, conv_k, **common)
        self.wx = Dense(f"{name}.wx", d_model, 4 * d_model, use_bias=True,
                        w_axes=("embed", "mlp"), **common)
        self.wr = Dense(f"{name}.wr", d_model, 4 * d_model, use_bias=False,
                        w_axes=("embed", "mlp"), **common)
        self.out_norm = RMSNorm(f"{name}.out_norm", d_model, **common)
        self.ffn_norm = RMSNorm(f"{name}.ffn_norm", d_model, **common)
        self.ffn = GatedMLP(f"{name}.ffn", d_model, d_ff, **common)

    def init(self, generator: torch.Generator) -> Params:
        p = {
            "norm": self.norm.init(generator),
            "conv": self.conv.init(generator),
            "wx": self.wx.init(generator),
            "wr": self.wr.init(generator),
            "out_norm": self.out_norm.init(generator),
            "ffn_norm": self.ffn_norm.init(generator),
            "ffn": self.ffn.init(generator),
        }
        d = self.d_model
        p["wx"]["b"][d:2 * d] = 3.0  # forget-gate bias
        return p

    def axes(self) -> AxesTree:
        return {
            "norm": self.norm.axes(),
            "conv": self.conv.axes(),
            "wx": self.wx.axes(),
            "wr": self.wr.axes(),
            "out_norm": self.out_norm.axes(),
            "ffn_norm": self.ffn_norm.axes(),
            "ffn": self.ffn.axes(),
        }

    def __call__(self, params: Params, x: torch.Tensor, ctx: Ctx, *,
                 cache: Optional[dict] = None):
        """Without ``cache`` returns the block's output; with it, (output,
        cache) after writing the new states into ``cache`` in place."""
        bsz, t, d = x.shape
        res = x
        xn = self.norm(params["norm"], x, ctx.scope("norm"))
        xc, conv_state = self.conv(params["conv"], xn, ctx.scope("conv"),
                                   state=None if cache is None else cache["conv"])
        xc = F.silu(xc)
        pre = self.wx(params["wx"], xc, ctx.scope("wx"))  # (B, T, 4d): the input stream
        if ctx.collect:  # the recurrent weight's tap rides on the input stream
            pre = ctx.tap("wr@out", pre, kind="matmul", T=t, D=d, p=4 * d,
                          param_path="wr/w", late=True)
        wr = reshard_param(params["wr"]["w"].to(pre.dtype), self.wr.w_axes, (d, 4 * d))
        if cache is not None:
            h, c, n, m = cache["h"], cache["c"], cache["n"], cache["m"]
        else:
            h = pre.new_zeros((bsz, d))
            c = torch.zeros((bsz, d), dtype=torch.float32, device=x.device)
            n = torch.zeros_like(c)
            m = torch.full_like(c, M_INIT)
        scan = SLSTMScan.apply if torch.is_grad_enabled() and ctx.remat else slstm_scan
        h_prev, h, c, n, m = scan(pre, h, c, n, m, wr)  # h_prev[:, t] = h_{t-1}
        if ctx.collect:
            ctx.record_act("wr@out", h_prev)
        # the outputs h_1 .. h_T: h_prev shifted by one step, then h_T
        y = torch.cat([h_prev[:, 1:], h[:, None]], dim=1)
        y = self.out_norm(params["out_norm"], y, ctx.scope("out_norm"))
        x = res + y
        x = x + self.ffn(params["ffn"], self.ffn_norm(params["ffn_norm"], x,
                                                      ctx.scope("ffn_norm")), ctx.scope("ffn"))
        if cache is None:
            return x
        cache["conv"].copy_(conv_state)
        for key, value in (("h", h), ("c", c), ("n", n), ("m", m)):
            cache[key].copy_(value)
        return x, cache

    def init_cache(self, batch: int, dtype: torch.dtype) -> dict:
        d, dev = self.d_model, self.device
        return {
            "conv": torch.zeros((batch, self.conv_k - 1, d), dtype=dtype, device=dev),
            "h": torch.zeros((batch, d), dtype=dtype, device=dev),
            "c": torch.zeros((batch, d), dtype=torch.float32, device=dev),
            "n": torch.zeros((batch, d), dtype=torch.float32, device=dev),
            "m": torch.full((batch, d), M_INIT, dtype=torch.float32, device=dev),
        }
