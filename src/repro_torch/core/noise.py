"""Gaussian noise addition for the DP mechanism (Eq. 2.1, second term).

Noise is drawn per parameter leaf, in path order, from one
``torch.Generator`` on the gradients' device, in fp32, then cast to the
gradient dtype.  The generator is the only source of randomness, so a step
is reproducible from its seed (the draws differ from the JAX package's).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.utils.tree import flatten_dict, unflatten_dict


def add_dp_noise(grad_sum: Any, generator: torch.Generator, noise_std: float,
                 layout: Optional[Any] = None) -> Any:
    """grad_sum + noise_std * N(0, I), leafwise independent.

    ``layout`` (a ``parallel.fsdp.ShardLayout``): ``grad_sum`` holds this
    rank's shards; each leaf's noise is drawn at the full shape from the
    replicated generator and this rank keeps its slice, so the noise equals
    the one-rank step's bit for bit."""
    out = {}
    for path, g in flatten_dict(grad_sum).items():
        shape = g.shape if layout is None else layout.full_shape(path, g.shape)
        z = torch.randn(shape, generator=generator, device=g.device, dtype=torch.float32)
        if layout is not None:
            z = layout.local(path, z)
        out[path] = g + (noise_std * z).to(g.dtype)
    return unflatten_dict(out)
