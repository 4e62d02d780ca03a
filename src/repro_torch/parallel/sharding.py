"""Logical-axis -> mesh-axis resolution (port of ``parallel/sharding.py``).

Parallelism layout, rule for rule the JAX package's:

- batch dims shard over (pod, data): data parallelism
- "embed" (the d_model dims of weights) shards over (pod, data): FSDP, the
  parameters and the optimizer moments are stored fully sharded
- "mlp"/"heads"/"kv_heads"/"vocab" shard over model: tensor parallelism
- "expert" shards over model when E % model_size == 0 (expert
  parallelism), else experts replicate and "moe_mlp" takes the model axis
- ``dp_only`` configs put the batch on every axis and keep the weights
  FSDP over (pod, data) only

Every rule is guarded by divisibility: a dim that does not divide evenly on
its target axes stays replicated (never a padded sharding).

A placement is one leaf's ``PartitionSpec`` entries as a plain tuple: per
dim ``None``, one mesh axis name, or a tuple of them.  Which of these the
port runs is the step's business (``parallel.fsdp``): this slice runs the
data axis; the rules are evaluated for any mesh.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.utils.tree import flatten_dict, unflatten_dict

Placement = tuple  # PartitionSpec entries: None | axis name | tuple of names


def mesh_axes(mesh: Mesh, cfg: Optional[ArchConfig] = None) -> dict[str, Any]:
    names = mesh.axis_names
    dp_only = cfg is not None and getattr(cfg, "parallelism", "tp") == "dp_only"
    if dp_only:
        # batch spans every axis; params stay FSDP over (pod, data) only
        batch_axes = tuple(a for a in ("pod", "data", "model") if a in names)
        fsdp_axes = tuple(a for a in ("pod", "data") if a in names)
        return {"batch": batch_axes, "fsdp": fsdp_axes, "model": ()}
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return {
        "batch": batch_axes,
        "fsdp": batch_axes,
        "model": ("model",) if "model" in names else (),
    }


def axis_size(mesh: Mesh, axes: tuple[str, ...]) -> int:
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def per_host_batch(global_batch: int, mesh: Mesh, cfg: Optional[ArchConfig] = None) -> int:
    """The largest slice of ``global_batch`` any single process holds.

    The memory certificates (the tuner's max-batch search, ``PrivacyEngine
    .recertify_max_batch``) are taken at this size: no one card ever holds
    the global batch of a fleet.  Rounded up when uneven; the whole batch
    when it does not shard at all.
    """
    from repro_torch.launch.mesh import mesh_host_count

    hosts = mesh_host_count(mesh)
    if hosts <= 1:
        return global_batch
    nb = axis_size(mesh, mesh_axes(mesh, cfg)["batch"])
    if nb <= 1 or global_batch % nb != 0:
        return global_batch
    # a process holds at most min(hosts, nb) distinct batch shards
    return -(-global_batch // min(hosts, nb))


def logical_rules(mesh: Mesh, cfg: Optional[ArchConfig] = None) -> dict[Optional[str], tuple]:
    ax = mesh_axes(mesh, cfg)
    model = ax["model"]
    rules: dict[Optional[str], tuple] = {
        "embed": ax["fsdp"],
        "mlp": model,
        "heads": model,
        "kv_heads": model,
        "vocab": model,
        "stack": (),
        None: (),
    }
    if cfg is not None and cfg.moe_experts:
        if cfg.moe_experts % max(axis_size(mesh, model), 1) == 0:
            rules["expert"] = model
            rules["moe_mlp"] = ax["fsdp"]  # shard expert d_ff over the fsdp axes
        else:
            rules["expert"] = ()
            rules["moe_mlp"] = model
    else:
        rules["expert"] = ()
        rules["moe_mlp"] = model
    return rules


def _spec_for(shape: tuple[int, ...], axes: tuple, rules: dict, mesh: Mesh) -> Placement:
    entries = []
    used: set[str] = set()
    for dim, logical in zip(shape, axes):
        target = tuple(a for a in rules.get(logical, ()) if a not in used)
        # longest divisible prefix
        while target and dim % axis_size(mesh, target) != 0:
            target = target[:-1]
        if target:
            entries.append(target if len(target) > 1 else target[0])
            used.update(target)
        else:
            entries.append(None)
    return tuple(entries)


def is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _flat_axes(axes_tree: Any, prefix: str = "") -> dict[str, tuple]:
    """{path: logical axes} of an axes tree (nested dicts of axes tuples)."""
    out: dict[str, tuple] = {}
    for k, v in axes_tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if is_axes_leaf(v):
            out[key] = v
        else:
            out.update(_flat_axes(v, key))
    return out


def param_shardings(model, mesh: Mesh, cfg: Optional[ArchConfig] = None,
                    params: Any = None) -> Any:
    """Placement tree of the model's parameters from its logical axes.

    ``params`` gives the shapes (any tree of tensors of the parameters'
    full shapes); without it they come from the ``meta`` device.
    """
    if params is None:
        from repro_torch.launch.flops import abstract_params

        params = abstract_params(model)
    rules = logical_rules(mesh, cfg)
    flat_axes = _flat_axes(model.axes())
    flat = flatten_dict(params)
    if set(flat_axes) != set(flat):
        raise ValueError(f"axes tree vs params: {sorted(set(flat_axes) ^ set(flat))}")
    out = {}
    for path, leaf in flat.items():
        ax = flat_axes[path]
        if len(ax) != len(leaf.shape):
            raise ValueError(f"{path}: axes {ax} vs shape {tuple(leaf.shape)}")
        out[path] = _spec_for(tuple(leaf.shape), ax, rules, mesh)
    return unflatten_dict(out)


def batch_shardings(specs: Any, mesh: Mesh, cfg: Optional[ArchConfig] = None) -> Any:
    """Inputs: dim 0 (batch) over the data axes (longest divisible prefix);
    a one-entry placement, as ``P(ax)``, or ``()`` where it replicates."""
    ax_full = mesh_axes(mesh, cfg)["batch"]

    def one(sp):
        ax = ax_full
        while ax and (not sp.shape or sp.shape[0] % axis_size(mesh, ax) != 0):
            ax = ax[:-1]
        if ax:
            return (ax if len(ax) > 1 else ax[0],)
        return ()

    return unflatten_dict({k: one(v) for k, v in flatten_dict(specs).items()})


def state_shardings(model, mesh: Mesh, cfg: ArchConfig, abstract_state: Any) -> Any:
    """Train-state placements: params and mirrored optimizer moments; the
    rest (step, generator, policy state) replicated, ``()``."""
    p_shard = param_shardings(model, mesh, cfg, params=abstract_state["params"])
    out = {}
    for k, v in abstract_state.items():
        if k == "params":
            out[k] = p_shard
        elif k == "opt" and isinstance(v, dict):
            # optimizer moments ("m"/"v") mirror the param tree's placements
            out[k] = {kk: mirror_tree(p_shard, vv) for kk, vv in v.items()}
        elif isinstance(v, dict):
            out[k] = unflatten_dict({kk: () for kk in flatten_dict(v)})
        else:
            out[k] = ()
    return out


def mirror_tree(p_shard: Any, moment_tree: Any) -> Any:
    flat_p = flatten_dict(p_shard)
    return unflatten_dict({k: flat_p[k] for k in flatten_dict(moment_tree)})


def serve_state_shardings(
    mesh: Mesh, cfg: ArchConfig, abstract_state: Any, batch_size: int
) -> Any:
    """Serve-state placements by leaf-path heuristics (divisibility-guarded):

    KV caches (..., B, S, K, hd): batch over (pod, data); S over model when
    the cache is long (context parallelism for decode), else K over model.
    SSM states (..., B, H, dk, dv): batch over (pod, data), H over model.
    """
    ax = mesh_axes(mesh, cfg)
    batch_ax_full, model_ax = ax["batch"], ax["model"]
    if not model_ax and "model" in mesh.axis_names:
        model_ax = ("model",)  # dp_only: long caches may still CP over model
    nm = axis_size(mesh, model_ax)

    def one(path: str, leaf) -> Placement:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if not shape:
            return ()
        batch_ax = batch_ax_full
        while batch_ax and batch_size % axis_size(mesh, batch_ax) != 0:
            batch_ax = batch_ax[:-1]
        nb = axis_size(mesh, batch_ax)
        # batch dim identified by value (stack dims precede it)
        bdim = None
        for i, s in enumerate(shape[: min(3, len(shape))]):
            if s == batch_size and nb > 1:
                bdim = i
                break
        if bdim is not None and nb > 1:
            spec[bdim] = batch_ax if len(batch_ax) > 1 else batch_ax[0]
        model_free = not (bdim is not None and "model" in (
            spec[bdim] if isinstance(spec[bdim], tuple) else (spec[bdim],)))
        is_kv = path.endswith("/k") or path.endswith("/v")
        if model_free and is_kv and len(shape) >= 4:
            sdim = len(shape) - 3  # (..., S, K, hd)
            if sdim != bdim and shape[sdim] >= 32768 and shape[sdim] % nm == 0 and nm > 1:
                spec[sdim] = "model"
            elif len(shape) - 2 != bdim and shape[len(shape) - 2] % nm == 0 and nm > 1:
                spec[len(shape) - 2] = "model"
        elif model_free and path.endswith("ssm") and len(shape) >= 4:
            hdim = len(shape) - 3
            if hdim != bdim and shape[hdim] % nm == 0 and nm > 1:
                spec[hdim] = "model"
        return tuple(spec)

    return unflatten_dict({k: one(k, v) for k, v in flatten_dict(abstract_state).items()})
