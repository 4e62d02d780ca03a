"""Analytic FLOPs model for the roofline compute term (port of
``launch/analytic.py``).

We build the exact matmul inventory from the DP tap metadata (every
parameterized matmul in the model registers a tap with its true (stack,
groups, B, T, D, p) — including MoE capacity and scan depth) and add the
parameter-free terms (attention scores, SSM scans, softmax/CE) per family.

Cost conventions: matmul (m,k)x(k,n) = 2mkn flops; backward = 2x forward;
remat adds one forward recompute per backward pass; the DP second backward
adds another backward; per-sample norms cost their branch's einsum.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.decision import decide
from repro_torch.core.taps import TapMeta


def matmul_fwd_flops(meta: dict[str, TapMeta]) -> float:
    total = 0.0
    for m in meta.values():
        if m.kind != "matmul":
            continue
        reps = m.n_stack * max(m.n_groups, 1)
        total += 2.0 * reps * m.batch_size * m.T * m.D * m.p
    return total


def norm_flops(meta: dict[str, TapMeta], mode: str, decision_by: str = "space") -> float:
    """Per-sample gradient-norm flops (the clipping module, Table 1)."""
    total = 0.0
    for m in meta.values():
        reps = m.n_stack * max(m.n_groups, 1)
        b = m.batch_size
        if m.kind == "matmul":
            branch = decide(m, mode=mode if not mode.endswith("_taps") else mode[:-5],
                            by=decision_by)
            if branch == "ghost":
                total += reps * b * (2.0 * m.T * m.T * (m.D + m.p))
            else:
                total += reps * b * (2.0 * m.T * m.D * m.p)
        elif m.kind == "embedding":
            total += reps * b * (2.0 * m.T * m.T * (1 + m.p))
        else:  # scale/bias/dw_conv: one elementwise pass
            total += reps * b * 2.0 * m.T * m.p
    return total


def attention_extra_flops(cfg: ArchConfig, shape: ShapeConfig, *, n_attn_layers: int) -> float:
    """Scores + AV matmuls (the full causal square, as the JAX package counts it)."""
    b = shape.global_batch
    hd = cfg.resolved_head_dim
    h = cfg.n_heads
    if shape.kind == "decode":
        s_kv = min(shape.seq_len, cfg.window or shape.seq_len)
        per_layer = 2.0 * b * 1 * s_kv * h * hd * 2
    else:
        s = shape.seq_len
        s_kv = min(s, cfg.window or s)
        per_layer = 2.0 * b * s * s_kv * h * hd * 2
    return n_attn_layers * per_layer


def ssm_extra_flops(cfg: ArchConfig, shape: ShapeConfig, *, n_ssm_layers: int,
                    d_inner: int, d_state: int, head_dim: int) -> float:
    b = shape.global_batch
    heads = d_inner // head_dim
    if shape.kind == "decode":
        # state update + readout: 2*B*H*dk*dv * 2
        return n_ssm_layers * 4.0 * b * heads * d_state * head_dim
    s = shape.seq_len
    chunk = cfg.ssm_chunk
    intra = 2.0 * b * s * chunk * heads * (d_state + head_dim)
    inter = 4.0 * b * s * heads * d_state * head_dim
    return n_ssm_layers * (intra + inter)


def _layer_census(cfg: ArchConfig) -> dict[str, int]:
    if cfg.block_pattern:
        period = cfg.block_pattern
        n_periods = cfg.n_layers // len(period)
        return {
            "attn": n_periods * sum(1 for k in period if k == "attn"),
            "mamba": n_periods * sum(1 for k in period if k == "mamba"),
            "mlstm": n_periods * sum(1 for k in period if k == "mlstm"),
            "slstm": n_periods * sum(1 for k in period if k == "slstm"),
        }
    return {"attn": cfg.n_layers + cfg.encoder_layers
            + (cfg.n_layers if cfg.family == "audio" else 0),  # cross-attn
            "mamba": 0, "mlstm": 0, "slstm": 0}


def extra_fwd_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    census = _layer_census(cfg)
    total = 0.0
    if census["attn"]:
        total += attention_extra_flops(cfg, shape, n_attn_layers=census["attn"])
    if census["mamba"]:
        total += ssm_extra_flops(
            cfg, shape, n_ssm_layers=census["mamba"],
            d_inner=2 * cfg.d_model, d_state=cfg.ssm_d_state, head_dim=cfg.ssm_head_dim,
        )
    if census["mlstm"]:
        total += ssm_extra_flops(
            cfg, shape, n_ssm_layers=census["mlstm"],
            d_inner=2 * cfg.d_model, d_state=2 * cfg.d_model // cfg.n_heads,
            head_dim=2 * cfg.d_model // cfg.n_heads,
        )
    if census["slstm"]:
        b = shape.global_batch
        s = 1 if shape.kind == "decode" else shape.seq_len
        total += census["slstm"] * 10.0 * b * s * cfg.d_model  # elementwise cell
    # CE / softmax over vocab
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    total += 3.0 * b * s * max(cfg.vocab, 1)
    return total


@dataclasses.dataclass(frozen=True)
class CellFlops:
    fwd: float
    total: float  # full step (train: fwd + backwards + norms [+ remat])
    norms: float

    def to_dict(self):
        return dataclasses.asdict(self)


def cell_flops(
    meta: dict[str, TapMeta], cfg: ArchConfig, shape: ShapeConfig, mode: str,
) -> CellFlops:
    fwd = matmul_fwd_flops(meta) + extra_fwd_flops(cfg, shape)
    if shape.kind != "train":
        return CellFlops(fwd=fwd, total=fwd, norms=0.0)
    norms = norm_flops(meta, mode) if mode not in ("non_private", "vmap") else 0.0
    remat = fwd if cfg.remat else 0.0
    if mode == "non_private":
        total = fwd + remat + 2.0 * fwd
    elif mode == "vmap":
        total = fwd + remat + 2.0 * fwd  # same flops; memory differs
    elif mode == "bk_mixed":
        # one backward; weighted grads replace the dW einsums (same cost)
        total = fwd + remat + 2.0 * fwd + norms
    else:
        # ghost family: bwd1 = dX chain (~fwd) + norms; bwd2 = full backward
        total = fwd + (remat + fwd + norms) + (remat + 2.0 * fwd)
    return CellFlops(fwd=fwd, total=total, norms=norms)


def serve_matmul_flops(model, cfg: ArchConfig, shape: ShapeConfig) -> float:
    """2 * tokens * active-matmul-params (embedding gathers excluded); the
    parameter shapes from the ``meta`` device (``flops.abstract_params``)."""
    from repro_torch.launch.flops import abstract_params
    from repro_torch.utils.tree import flatten_dict

    flat = flatten_dict(abstract_params(model))
    active = 0.0
    for path, leaf in flat.items():
        n = float(math.prod(leaf.shape))
        base = path.rsplit("/", 1)[0]
        if base.endswith("embed") or base.endswith("enc_pos") or base.endswith("pos_embed"):
            continue
        if cfg.moe_experts and ("moe/wg" in path or "moe/wu" in path or "moe/wo" in path):
            active += n * cfg.moe_top_k * cfg.capacity_factor / cfg.moe_experts
        else:
            active += n
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    return 2.0 * tokens * active
