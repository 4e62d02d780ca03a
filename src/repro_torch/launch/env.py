"""Launch environment harness: the variables a run depends on, applied
BEFORE torch is imported (port of ``launch/env.py``).

Step timings and restarts are only comparable when the process
environment is pinned.  Two variables matter to the port, each set by
default and never clobbered (anything the user already exported wins):

* ``PYTORCH_CUDA_ALLOC_CONF``: ``expandable_segments:True``, so the
  max-batch trial ladder (``repro_torch.tuner.max_batch``) gets a failed
  trial's memory back instead of leaving it fragmented in cached segments;
* ``CUBLAS_WORKSPACE_CONFIG``: ``:4096:8``, which
  ``torch.use_deterministic_algorithms(True)`` requires of cuBLAS calls.
  The train CLI does not switch that mode on (its one non-deterministic op,
  the embedding's weighted gradient, has a deterministic form instead), but
  a caller that does needs the variable set before cuBLAS starts.

The JAX package's XLA flags (``XLA_FLAGS``, the TPU step markers, the
preallocation switch) have no counterpart: the port's steps are eager
PyTorch, its profiler marks steps itself (``obs.profile``), and the caching
allocator never preallocates.  This module must not import torch; reading
an already-imported torch is fine (``host_fingerprint``).
"""
from __future__ import annotations

import os
import platform
import sys
import warnings

ENV_DEFAULTS = {
    "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
    "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
}


def apply_env() -> None:
    """Pin the launch environment (idempotent; user-set values win).

    Warns (but proceeds) when torch is already imported: the allocator and
    cuBLAS read these when CUDA starts, so a process that has started it
    keeps what it had.
    """
    if "torch" in sys.modules:
        warnings.warn(
            "repro_torch.launch.env.apply_env() called after torch was imported; "
            "a CUDA context already started keeps its allocator and cuBLAS settings",
            stacklevel=2,
        )
    for key, value in ENV_DEFAULTS.items():
        os.environ.setdefault(key, value)


def _device_tag() -> str:
    """``gpu:<name>`` of CUDA device 0 when torch is imported and sees one,
    else ``cpu``; never imports torch itself."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return "cpu"
    return "gpu:" + torch.cuda.get_device_name(0).replace(" ", "_")


def host_fingerprint() -> str:
    """Coarse same-host-class tag: ``machine-cpucount-device`` (e.g.
    ``x86_64-8-gpu:NVIDIA_H100_80GB_HBM3``).  Two runs with equal
    fingerprints ran on comparable hosts and the same kind of card."""
    return f"{platform.machine()}-{os.cpu_count()}-{_device_tag()}"
