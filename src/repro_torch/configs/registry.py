"""Architecture registry: ``--arch <id>`` resolution and model construction
(port of ``configs/registry.py`` for the archs ported so far).

``ARCHS`` holds the dense, MoE, hybrid and SSM decoder LMs, which train and
serve.  The other archs of the JAX registry are known by name and raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs import (
    arctic_480b,
    codeqwen1_5_7b,
    jamba_1_5_large,
    mixtral_8x7b,
    qwen1_5_32b,
    qwen2_72b,
    xlstm_350m,
    yi_6b,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (
    yi_6b.CONFIG, codeqwen1_5_7b.CONFIG, qwen1_5_32b.CONFIG, qwen2_72b.CONFIG,
    mixtral_8x7b.CONFIG, arctic_480b.CONFIG, jamba_1_5_large.CONFIG, xlstm_350m.CONFIG,
)}

NOT_PORTED: dict[str, str] = {
    "whisper-large-v3": "the encoder-decoder slice",
    "phi-3-vision-4.2b": "the VLM slice",
}


def _canonical(name: str) -> str:
    key = name.strip()
    alt = key.replace("_", "-").replace(".", "-")
    for known in (*ARCHS, *NOT_PORTED):
        if key == known or known.replace(".", "-") == alt:
            return known
    raise KeyError(f"unknown arch {name!r}; have {sorted((*ARCHS, *NOT_PORTED))}")


def get_arch(name: str) -> ArchConfig:
    key = _canonical(name)
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"arch {key!r} is not ported yet: it comes with {NOT_PORTED[key]}"
        )
    return ARCHS[key]


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Any:
    """The model of ``cfg`` on ``device`` (the GPU unless asked otherwise)."""
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(cfg, device=device)
