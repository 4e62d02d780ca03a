"""Weights and gradients between the JAX package's layouts and the port's.

Both packages key parameters by the same nested-dict paths.  They differ
only in the convolution weight layout: HWIO (kh, kw, d_in, d_out) in JAX,
OIHW (d_out, d_in, kh, kw) here.  Dense weights keep the JAX layout
(d_in, d_out) in both, and vectors need no change.  Everything crosses as
numpy arrays, so neither side imports the other.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.tree import flatten_dict, unflatten_dict


def params_from_jax(tree: Mapping[str, Any], device: DeviceLike = None) -> dict:
    """JAX-layout parameter tree (numpy arrays) -> the port's parameters."""
    dev = resolve_device(device)
    out = {}
    for path, leaf in flatten_dict(tree).items():
        x = torch.as_tensor(np.array(leaf))
        if x.ndim == 4:  # conv HWIO -> OIHW
            x = x.permute(3, 2, 0, 1)
        out[path] = x.contiguous().to(dev)
    return unflatten_dict(out)


def grads_to_jax_layout(tree: Mapping[str, Any]) -> dict:
    """The port's gradient (or parameter) tree -> JAX-layout numpy arrays."""
    out = {}
    for path, leaf in flatten_dict(tree).items():
        x = leaf.detach().cpu()
        if x.ndim == 4:  # conv OIHW -> HWIO
            x = x.permute(2, 3, 1, 0)
        out[path] = x.contiguous().numpy()
    return unflatten_dict(out)


def batch_from_numpy(batch: Mapping[str, Any], device: DeviceLike = None) -> dict:
    """A numpy batch (the JAX package's keys and layouts) -> tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v)).to(dev) for k, v in batch.items()}
