"""Gaussian noise addition for the DP mechanism (Eq. 2.1, second term).

Noise is drawn per parameter leaf, in path order, from one
``torch.Generator`` on the gradients' device, in fp32, then cast to the
gradient dtype.  The generator is the only source of randomness, so a step
is reproducible from its seed (the draws differ from the JAX package's).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.tree import tree_map


def add_dp_noise(grad_sum: Any, generator: torch.Generator, noise_std: float) -> Any:
    """grad_sum + noise_std * N(0, I), leafwise independent."""

    def noisy(g: torch.Tensor) -> torch.Tensor:
        z = torch.randn(g.shape, generator=generator, device=g.device, dtype=torch.float32)
        return g + (noise_std * z).to(g.dtype)

    return tree_map(noisy, grad_sum)
