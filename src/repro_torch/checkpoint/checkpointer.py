"""Atomic checkpointing of a train state (port of ``checkpoint/checkpointer.py``).

Format, the JAX package's: one ``step_N.npz`` of the state's flattened
(``"a/b/c"`` -> array) leaves plus a ``step_N.json`` sidecar (step, each
leaf's shape and dtype, ``FORMAT_VERSION``).  Writes go to a temp file then
``os.replace``: a crash mid-save never corrupts the latest checkpoint.  A
bf16 leaf is stored as the JAX package stores it, its 16-bit pattern as a
``V2`` array, with ``"bfloat16"`` in the sidecar.

The port's state is not a tree of arrays only: ``make_train_state`` keeps
the step as a Python int and the noise generator as a ``torch.Generator``.
``snapshot_state`` turns it into host values a writer thread may own: each
tensor a real copy on the CPU (the optimizer and the step update tensors in
place), each generator its ``get_state()`` bytes, each number as is.  A
restore with ``cast_to`` (the state the run built) puts every leaf back as
that state has it: a tensor on its device in its dtype, a generator of its
device with the saved state set, an int or a float.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import flatten_dict, unflatten_dict

log = get_logger("checkpoint")

# full-name match: ".tmp_step_5.npz" (an in-flight or torn temp file) must
# never be reported as a restorable step
_STEP_RE = re.compile(r"step_(\d+)\.npz")
FORMAT_VERSION = 1


def _snapshot_leaf(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return x.get_state()  # a fresh CPU uint8 tensor
    return x


def snapshot_state(state: Mapping[str, Any]) -> dict:
    """The state as host values that nothing else writes to: tensors copied
    to the CPU, generators as their state bytes (a device-to-host sync)."""
    out: dict = {}
    for k, v in state.items():
        out[k] = snapshot_state(v) if isinstance(v, Mapping) else _snapshot_leaf(v)
    return out


def _to_numpy(x: Any) -> np.ndarray:
    x = _snapshot_leaf(x) if isinstance(x, (torch.Tensor, torch.Generator)) else x
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:  # as the JAX package writes it: V2
            return x.contiguous().view(torch.int16).numpy().view("V2")
        return x.contiguous().numpy()
    return np.asarray(x)


def _leaf_dtype(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def save_checkpoint(directory: str | os.PathLike, step: int, state: Any) -> pathlib.Path:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in flatten_dict(state).items()}
    tmp = d / f".tmp_step_{step}.npz"
    final = d / f"step_{step}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    meta = {
        "step": int(step),
        "format": FORMAT_VERSION,
        "leaves": {k: {"shape": list(v.shape), "dtype": _leaf_dtype(v)}
                   for k, v in arrays.items()},
    }
    mtmp = d / f".tmp_step_{step}.json"
    mfinal = d / f"step_{step}.json"
    mtmp.write_text(json.dumps(meta))
    os.replace(mtmp, mfinal)
    log.info("saved checkpoint step=%d (%d leaves) -> %s", step, len(arrays), final)
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir() if (m := _STEP_RE.fullmatch(p.name))]
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):  # a bf16 leaf's bit pattern
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _cast_leaf(path: str, arr: np.ndarray, like: Any) -> Any:
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(np.array(arr, dtype=np.uint8)))
        return gen
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {path} has shape {tuple(arr.shape)}, "
                             f"the state {tuple(like.shape)}")
        return _to_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    raise TypeError(f"state leaf {path} is a {type(like).__name__}; have no rule to restore it")


def cast_state(flat: Mapping[str, Any], like: Mapping[str, Any],
               fill: tuple[str, ...] = (), prefix: str = "") -> dict:
    """The saved leaves ``flat`` (``"a/b/c"`` -> array) in the structure of
    ``like``, each leaf as ``like`` holds it (empty subtrees kept).  A
    top-level subtree named in ``fill`` that the checkpoint lacks entirely
    keeps ``like``'s (a checkpoint from before the policy state existed);
    any other leaf that one side has and the other lacks raises ``KeyError``."""
    if not prefix:
        extra = set(flat) - set(flatten_dict(like))
        if extra:
            raise KeyError(f"checkpoint leaves not in the state: {sorted(extra)[:5]}")
    out: dict = {}
    for k, v in like.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if not prefix and k in fill and not any(p.startswith(f"{k}/") for p in flat):
            if flatten_dict(v):
                log.info("checkpoint has no %s subtree: starting it fresh", k)
            out[k] = v
        elif isinstance(v, Mapping):
            out[k] = cast_state(flat, v, prefix=path)
        elif path not in flat:
            raise KeyError(f"state leaf {path} is not in the checkpoint")
        else:
            out[k] = _cast_leaf(path, flat[path], v)
    return out


def restore_checkpoint(
    directory: str | os.PathLike,
    step: Optional[int] = None,
    *,
    cast_to: Any = None,
    fill: tuple[str, ...] = (),
) -> tuple[int, Any]:
    """Returns (step, state): numpy leaves, or with ``cast_to`` (a state of
    the same structure) each leaf as ``cast_state`` puts it (``fill``: the
    subtrees a checkpoint may lack)."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
    path = d / f"step_{step}.npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    state = cast_state(flat, cast_to, fill) if cast_to is not None else unflatten_dict(flat)
    log.info("restored checkpoint step=%d from %s", step, path)
    return step, state
