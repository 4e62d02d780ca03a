"""Poisson subsampling for DP-SGD (port of ``data/poisson.py``).

The RDP accountant assumes each example joins a batch independently with
probability q = B/N.  With fixed-shape batches we draw a Bernoulli(q')
inclusion mask over the B slots; masked samples get zero clip weight
(C_i *= mask), so the mechanism sees a Poisson-sampled batch of random
size <= B.
"""
from __future__ import annotations

import torch


def poisson_sample_mask(
    generator: torch.Generator, batch: int, sampling_rate: float,
    slots_per_sample: float = 1.25,
) -> torch.Tensor:
    """(B,) float mask on the generator's device; slots are over-provisioned
    by ``slots_per_sample`` so truncation is vanishingly rare."""
    q = min(1.0, sampling_rate * slots_per_sample)
    probs = torch.full((batch,), q, dtype=torch.float32, device=generator.device)
    return torch.bernoulli(probs, generator=generator)
