"""Useful-FLOPs model (port of ``launch/flops.py``): MODEL_FLOPS = 6*N*D
(train) / 2*N*D (inference), with N = active parameters (MoE counts top-k
of E experts + shared paths).

The parameter tree comes from the ``meta`` device, where the JAX package
takes it from ``jax.eval_shape``: shapes and dtypes, nothing allocated, so
a full-width model costs no memory.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.utils.tree import flatten_dict, tree_map


def abstract_params(model) -> dict:
    """``model``'s parameter tree on the ``meta`` device: a registry model's
    twin is built there when it lives elsewhere; a model no registry
    configuration builds (the CNNs, the ViTs) runs its ``init`` over fake
    tensors, which allocate nothing, and its leaves are given on ``meta``."""
    if model.device.type == "meta":
        return model.init(torch.Generator())
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.family not in ("cnn", "vit"):
        from repro_torch.configs.registry import build_model

        return build_model(cfg, device="meta").init(torch.Generator())
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = torch._guards.detect_fake_mode()
    with contextlib.nullcontext() if fake is not None else FakeTensorMode():
        params = model.init(torch.Generator(device=model.device))
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params)


def count_params(model, cfg: ArchConfig) -> tuple[int, int]:
    """(total_params, active_params) from the abstract param tree."""
    flat = flatten_dict(abstract_params(model))
    total = 0
    active = 0
    for path, leaf in flat.items():
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n
        if cfg.moe_experts and ("moe/wg" in path or "moe/wu" in path or "moe/wo" in path):
            active += n * cfg.moe_top_k // cfg.moe_experts
        else:
            active += n
    return total, active


def model_flops(model, cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs for one step of this (arch, shape) cell."""
    _, active = count_params(model, cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence; embedding/lm_head still touched per token
    return 2.0 * active * shape.global_batch
