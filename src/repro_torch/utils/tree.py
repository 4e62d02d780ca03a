"""Nested-dict helpers: parameters are nested dicts of tensors, keyed by
``"a/b/c"`` paths when flat (the same paths as the JAX package)."""
from __future__ import annotations

from typing import Any, Mapping


def flatten_dict(d: Mapping[str, Any], sep: str = "/", prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, sep=sep, prefix=key))
        else:
            out[key] = v
    return out


def unflatten_dict(d: Mapping[str, Any], sep: str = "/") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in d.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def tree_map(fn, *trees: Mapping[str, Any]) -> dict[str, Any]:
    """Apply ``fn`` leafwise over nested dicts of the same structure."""
    flats = [flatten_dict(t) for t in trees]
    return unflatten_dict({k: fn(*(f[k] for f in flats)) for k in flats[0]})
