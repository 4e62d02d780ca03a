"""Deterministic synthetic image batches (port of ``data/synthetic.py``'s
``synthetic_vision_batch``; the LM streams come with the LM slice).

Batches are made on the target device from explicit generators seeded by
(seed, step, shard), so a step's batch is a pure function of those three
numbers.  The draws differ from the JAX package's; tests that compare the
two packages make their inputs with numpy instead.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device


def _generator(device: torch.device, *key: int) -> torch.Generator:
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(seed)


def synthetic_vision_batch(
    *, batch: int, image: int, channels: int, n_classes: int, step: int,
    shard: int = 0, seed: int = 0, device: DeviceLike = None,
) -> dict:
    """Class-conditional Gaussian blobs: {"image": (B, H, W, C) f32,
    "label": (B,) int64, "mask": (B,) f32}."""
    dev = resolve_device(device)
    gen = _generator(dev, seed, step, shard)
    labels = torch.randint(0, n_classes, (batch,), generator=gen, device=dev)
    # class prototypes depend on the seed only (step-invariant), otherwise
    # the task is unlearnable
    protos = torch.randn(
        (n_classes, image, image, channels), generator=_generator(dev, seed, 9999), device=dev
    )
    noise = torch.randn((batch, image, image, channels), generator=gen, device=dev)
    return {
        "image": protos[labels] + 0.5 * noise,
        "label": labels,
        "mask": torch.ones((batch,), dtype=torch.float32, device=dev),
    }
