"""Input specs per (architecture x shape) (port of ``launch/specs.py``).

The specs are ``meta``-device tensors: shape and dtype, nothing allocated,
where the JAX package has ``ShapeDtypeStruct``.  ``materialize`` builds
concrete tensors from them with an explicit ``torch.Generator``.  The
modality frontends are stubs, as in the JAX package: Whisper gets frame
embeddings, Phi-3-vision patch embeddings.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, torch_dtype
from repro_torch.utils.tree import flatten_dict, unflatten_dict


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def per_device_batch(shape: ShapeConfig, n_data_shards: int) -> int:
    assert shape.global_batch % n_data_shards == 0 or n_data_shards % shape.global_batch == 0
    return max(1, shape.global_batch // n_data_shards)


def _frontend(cfg: ArchConfig, batch: int) -> dict:
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "audio":
        return {"frames": _spec((batch, cfg.encoder_seq, cfg.d_model), dt)}
    if cfg.family == "vlm":
        return {"prefix": _spec((batch, cfg.prefix_tokens, cfg.prefix_dim), dt)}
    return {}


def _text_len(cfg: ArchConfig, s: int) -> int:
    return s - cfg.prefix_tokens if cfg.family == "vlm" else s


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, batch: int) -> dict:
    text = _text_len(cfg, shape.seq_len)
    specs = _frontend(cfg, batch)
    specs["tokens"] = _spec((batch, text), torch.int32)
    specs["labels"] = _spec((batch, text), torch.int32)
    specs["mask"] = _spec((batch,), torch.float32)
    return specs


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig, batch: int) -> dict:
    specs = _frontend(cfg, batch)
    specs["tokens"] = _spec((batch, _text_len(cfg, shape.seq_len)), torch.int32)
    return specs


def decode_token_specs(batch: int) -> torch.Tensor:
    return _spec((batch, 1), torch.int32)


def serve_state_specs(model, cfg: ArchConfig, shape: ShapeConfig, batch: int) -> dict:
    """The serve state (KV caches, SSM states) of ``shape`` on the meta
    device: a twin of the model is built there."""
    from repro_torch.configs.registry import build_model

    twin = model if model.device.type == "meta" else build_model(cfg, device="meta")
    return twin.init_state(batch, shape.seq_len)


def local_serve_state(model, cfg: ArchConfig, shape: ShapeConfig, batch: int,
                      placements: Any, mesh) -> dict:
    """This rank's serve state of ``shape`` on the model's device, built at
    its local shapes under ``placements`` (``parallel.sharding
    .local_serve_shardings``) without the full state: every leaf holds the
    value ``init_state`` fills it with (zeros, -1 in an empty cache row's
    position, the sLSTM's stabiliser start).  ``parallel.fsdp.ShardLayout``
    (``shard``, ``gather``) moves a full state to and from a rank's.  The
    fill is copied on the device (no host read: the state of a dry run's
    fake tensors is built here too)."""
    from repro_torch.parallel.fsdp import local_shape

    fills = flatten_dict(model.init_state(1, 1))
    flat_p = flatten_dict(placements)
    out = {}
    for path, sp in flatten_dict(serve_state_specs(model, cfg, shape, batch)).items():
        leaf = torch.empty(local_shape(sp.shape, flat_p[path], mesh), dtype=sp.dtype,
                           device=model.device)
        out[path] = leaf.copy_(fills[path].reshape(-1)[0])
    return unflatten_dict(out)


def materialize(specs: Any, generator: torch.Generator, vocab: int = 128,
                device=None) -> Any:
    """Concrete tensors from specs, on ``device`` (default: the generator's):
    integer leaves uniform in [0, vocab), a 1-D float leaf (the sample mask)
    ones, other floats standard normal; leaves drawn in path order."""
    dev = generator.device if device is None else torch.device(device)
    out = {}
    for path, sp in flatten_dict(specs).items():
        if not sp.dtype.is_floating_point:
            out[path] = torch.randint(0, max(vocab, 2), tuple(sp.shape), generator=generator,
                                      device=dev, dtype=torch.int64).to(sp.dtype)
        elif sp.ndim == 1:
            out[path] = torch.ones(tuple(sp.shape), dtype=sp.dtype, device=dev)
        else:
            out[path] = torch.randn(tuple(sp.shape), generator=generator, device=dev,
                                    dtype=torch.float32).to(sp.dtype)
    return unflatten_dict(out)
