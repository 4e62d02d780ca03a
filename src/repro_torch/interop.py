"""Weights and gradients between the JAX package's layouts and the port's.

Both packages key parameters by the same nested-dict paths.  They differ
only in the convolution weight layout: HWIO (kh, kw, d_in, d_out) in JAX,
OIHW (d_out, d_in, kh, kw) here.  Which leaves are conv weights, the
model says: ``conv_weights`` are the paths of its ``Conv2d`` modules'
weights, collected when it is built (``model.conv_weights``).  Every other
leaf keeps its layout, stacked or grouped 4-D leaves included: an MoE
layer's ``router/w`` (L, d, E), ``wg``/``wu`` (L, E, d, f) and ``wo``
(L, E, f, d), and Arctic's ``dense_mlp``, as the JAX package lays them out,
and the depthwise conv kernels of the Mamba and xLSTM blocks, which keep
the JAX layout (k, d) (stacked (L, k, d)): they are no ``Conv2d`` weight.
Everything crosses as numpy arrays, so neither side imports the other.
A bf16 leaf (Jamba's ``param_dtype``) crosses bit for bit: numpy's
``bfloat16`` (the ``ml_dtypes`` type the JAX package hands out) is read
through its 16-bit pattern, and written back the same way.

``plan_from_jax`` carries a tuner ``ClipPlan`` across (its JSON): the same
schema and shape fingerprint, with the kernel impls renamed.
"""
from __future__ import annotations

from typing import Any, Collection, Mapping

import json

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import flatten_dict, unflatten_dict


def _conv_leaves(flat: Mapping[str, Any], conv_weights: Collection[str]) -> set[str]:
    """The named conv weights, each of which must be a 4-D leaf of the tree."""
    for path in conv_weights:
        if path not in flat:
            raise KeyError(f"conv weight {path} is not a leaf of the tree")
        if flat[path].ndim != 4:
            raise ValueError(
                f"conv weight {path} has shape {tuple(flat[path].shape)}, expected 4-D")
    return set(conv_weights)


def _to_torch(leaf: Any) -> torch.Tensor:
    """A numpy leaf as a tensor; numpy's bfloat16 through its bit pattern."""
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bf16 as numpy's bfloat16 (``ml_dtypes``)."""
    if x.dtype == torch.bfloat16:
        import ml_dtypes

        return x.contiguous().view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return x.contiguous().numpy()


def params_from_jax(
    tree: Mapping[str, Any], conv_weights: Collection[str], device: DeviceLike = None
) -> dict:
    """JAX-layout parameter tree (numpy arrays) -> the port's parameters."""
    dev = resolve_device(device)
    flat = flatten_dict(tree)
    convs = _conv_leaves(flat, conv_weights)
    out = {}
    for path, leaf in flat.items():
        x = _to_torch(leaf)
        if path in convs:  # HWIO -> OIHW
            x = x.permute(3, 2, 0, 1)
        out[path] = x.contiguous().to(dev)
    return unflatten_dict(out)


def grads_to_jax_layout(tree: Mapping[str, Any], conv_weights: Collection[str]) -> dict:
    """The port's gradient (or parameter) tree -> JAX-layout numpy arrays."""
    flat = flatten_dict(tree)
    convs = _conv_leaves(flat, conv_weights)
    out = {}
    for path, leaf in flat.items():
        x = leaf.detach().cpu()
        if path in convs:  # OIHW -> HWIO
            x = x.permute(2, 3, 1, 0)
        out[path] = _to_numpy(x)
    return unflatten_dict(out)


def batch_from_numpy(batch: Mapping[str, Any], device: DeviceLike = None) -> dict:
    """A numpy batch (the JAX package's keys and layouts) -> tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v)).to(dev) for k, v in batch.items()}


# the JAX package's kernel impls and the port's counterparts
_JAX_IMPLS = {"pallas": "cuda", "xla": "torch"}


def plan_from_jax(text: str, *, device: DeviceLike = None):
    """A JAX-package ``ClipPlan`` JSON -> the port's ``ClipPlan``.

    The kernel impls map ``pallas`` -> ``cuda`` and ``xla`` -> ``torch``;
    the shape fingerprint and both branch maps are kept as written (the
    fingerprints of one model agree across the packages).  The plan keeps
    the device it was measured on, so ``matches`` holds only where that
    device runs, unless ``device`` is given: then it is restamped to that
    device's string (the caller vouches that the measurement applies).
    """
    from repro_torch.tuner.plan import ClipPlan, device_string

    d = json.loads(text)
    d["kernels"] = [[name, op, _JAX_IMPLS.get(impl, impl)]
                    for name, op, impl in d.get("kernels", ())]
    if device is not None:
        d["device"] = device_string(device)
    return ClipPlan.from_json(json.dumps(d))
