"""Architecture registry: ``--arch <id>`` resolution and model construction
(port of ``configs/registry.py``'s LM archs).

``ARCHS`` holds every LM arch of the JAX registry: the dense, MoE, hybrid
and SSM decoder LMs, the VLM (a decoder LM with a projected patch prefix)
and the encoder-decoder (Whisper), all of which train and serve.
``build_model`` sends the audio family to ``EncDecLM`` and the rest to
``DecoderLM``, as the JAX package does.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs import (
    arctic_480b,
    codeqwen1_5_7b,
    jamba_1_5_large,
    mixtral_8x7b,
    phi_3_vision,
    qwen1_5_32b,
    qwen2_72b,
    whisper_large_v3,
    xlstm_350m,
    yi_6b,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (
    yi_6b.CONFIG, codeqwen1_5_7b.CONFIG, qwen1_5_32b.CONFIG, qwen2_72b.CONFIG,
    mixtral_8x7b.CONFIG, arctic_480b.CONFIG, jamba_1_5_large.CONFIG, xlstm_350m.CONFIG,
    phi_3_vision.CONFIG, whisper_large_v3.CONFIG,
)}


def _canonical(name: str) -> str:
    key = name.strip()
    alt = key.replace("_", "-").replace(".", "-")
    for known in ARCHS:
        if key == known or known.replace(".", "-") == alt:
            return known
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


def get_arch(name: str) -> ArchConfig:
    return ARCHS[_canonical(name)]


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Any:
    """The model of ``cfg`` on ``device`` (the GPU unless asked otherwise)."""
    if cfg.family == "audio":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg, device=device)
    from repro_torch.models.lm import DecoderLM

    return DecoderLM(cfg, device=device)
