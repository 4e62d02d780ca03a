"""Deterministic synthetic batches (port of ``data/synthetic.py``): image
blobs, the LM token stream, a first-order Markov chain (token t+1 =
(31 t + 7) mod V, replaced by a uniform draw with probability ``noise``)
whose loss falls under training, and the VLM prefix and audio frames of
the stub frontends.

Batches come from explicit generators seeded by (seed, step, shard), so a
step's batch is a pure function of those three numbers.  The image blobs
are drawn on the target device; the token chain is drawn and run on the
CPU (its scan is sequential, 2 + S small ops) and moved once, so a batch is
the same on every device.  The draws differ from the JAX package's; tests
that compare the two packages make their inputs with numpy instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import torch_dtype
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


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    markov_mult: int = 31
    noise: float = 0.1


def synthetic_lm_batch(cfg: SyntheticLMConfig, step: int, shard: int = 0,
                       device: DeviceLike = None) -> dict:
    """{"tokens": (B, S) int64, "labels": (B, S) int64 (the next token),
    "mask": (B,) f32} on ``device``."""
    dev = resolve_device(device)
    gen = _generator(torch.device("cpu"), cfg.seed, step, shard)
    b, s, v = cfg.batch, cfg.seq_len, cfg.vocab
    tok = torch.randint(0, v, (b,), generator=gen)
    noise = torch.rand((s + 1, b), generator=gen) < cfg.noise
    rand = torch.randint(0, v, (s + 1, b), generator=gen)
    seq = torch.empty((s + 1, b), dtype=torch.long)
    for t in range(s + 1):
        tok = torch.where(noise[t], rand[t], (tok * cfg.markov_mult + 7) % v)
        seq[t] = tok
    seq = seq.T.to(dev)
    return {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous(),
            "mask": torch.ones((b,), dtype=torch.float32, device=dev)}


def synthetic_arch_batch(cfg, *, batch: int, seq: int, step: int = 0, shard: int = 0,
                         device: DeviceLike = None) -> dict:
    """The batch an ``ArchConfig``'s family trains on (shared by the tuner
    CLI and the examples, so both profile and train on the same shapes):
    tokens and labels of ``seq - prefix_tokens`` positions, plus the stub
    frontends' inputs in ``cfg.dtype``: a VLM's patch embeddings ``prefix``
    (B, prefix_tokens, prefix_dim) and the audio family's frame embeddings
    ``frames`` (B, encoder_seq, d_model), standard normal draws from
    generators seeded by (77 or 78, step, shard), as the JAX package keys
    them by 77 and 78 and the step."""
    dev = resolve_device(device)
    prefix_tokens = getattr(cfg, "prefix_tokens", 0) or 0
    if seq <= prefix_tokens:
        raise ValueError(f"{cfg.name}: seq {seq} leaves no text after {prefix_tokens} "
                         "prefix positions")
    b = synthetic_lm_batch(SyntheticLMConfig(vocab=cfg.vocab, seq_len=seq - prefix_tokens,
                                             batch=batch), step, shard, device=dev)
    dtype = torch_dtype(getattr(cfg, "dtype", "float32"))
    if cfg.family == "vlm":
        b["prefix"] = torch.randn((batch, cfg.prefix_tokens, cfg.prefix_dim),
                                  generator=_generator(dev, 77, step, shard),
                                  device=dev).to(dtype)
    if cfg.family == "audio":
        b["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                  generator=_generator(dev, 78, step, shard),
                                  device=dev).to(dtype)
    return b
