"""Multi-pod dry run without a compiler (port of ``launch/dryrun.py``):
evaluate every (arch x shape x mesh) cell's step for one rank of a fleet of
H100s, abstractly.

The JAX module lowers and AOT-compiles each cell for 512 placeholder TPU
devices and reads the compiled program's memory and cost analysis.  The
port has no SPMD compiler; it runs rank 0's eager step itself, at the
rank's local shapes, over fake tensors (``FakeTensorMode``: shapes and
dtypes, nothing allocated, no value) and a fake process group of the
mesh's size (``launch.mesh.fake_process_group``: the collectives issue and
move nothing), through the port's own ``parallel/*`` code.  What a real
rank 0 would hold and move is recorded as the step runs:

- the state and batch at the rank's shapes under the placements
  (``parallel.sharding``: ``state_shardings``, ``batch_shardings``;
  serving ``param_shardings`` and ``local_serve_shardings``), the live
  mesh of ``(2, 16, 16)`` with its pod axis folded into data
  (``launch.mesh.live_shape``; a cell whose placements would name "pod"
  alone errors);
- ``launch.analysis.MemoryTracker``: the live bytes of every storage at
  their peak (``peak_bytes_estimate``) and the bytes every op reads and
  writes;
- ``parallel.collectives.recording``: every collective's kind, bytes and
  group size, for the ring model (``analysis.CollectiveStats``);
- the kernels' launches: a fake tensor resolves to the card's kernels
  (``kernels.dispatch.abstract_cuda``), whose abstract
  evaluation allocates their outputs and workspaces and counts a ``fake``
  launch, so the prediction is of the kernels' memory, not of the plain
  versions' (B, T, T) Grams.

The compute term is analytic (``launch.analytic``), as in the JAX module;
the hardware constants are the H100's (``launch.analysis``), so every
figure here is a prediction for the card, not a measurement.

Divergences from the JAX module, by design:

- No compiler: the step is the eager program, evaluated over fake tensors
  on the CPU device (autograd refuses fake CUDA tensors where torch has no
  CUDA); the dispatch is told the target is the card.
- ``hlo_raw.bytes`` (and ``bytes_per_device``) is the sum of the operand
  and output bytes of every dispatched op, views excluded: op by op, not
  XLA's count of a fused program, so the two are not comparable.
  ``hlo_raw.collectives`` comes from the collective record, not from HLO.
- ``memory_stats``: ``argument_bytes`` is the rank's state and batch
  shards under the placements (the JAX ``in_shardings``' bytes); the peak
  counts what the port's rank holds, the global batch included (each rank
  is given it and keeps its rows), and the old state beside the new one (no
  donation); ``temp_bytes`` is the peak less the arguments and the outputs
  plus the aliased outputs, the identity of XLA's figures.
- Full depth: an eager step has no ``lax.scan`` whose body a cost analysis
  counts once, so no cell needs the 1- and 2-period extrapolation;
  ``--no-calibrate`` is accepted and every JSON says ``"calibrated":
  false``.
- A one-device mesh runs the one-process step (what one card runs), with
  no process group.
- Serving runs inside ``use_reshard_rules`` (the port's sharded serve steps
  need the live mesh; the JAX module leaves serving to GSPMD's plan).
- Beyond the JAX schema each cell's JSON has ``"launches"``: the kernels'
  predicted launches by kernel.

Usage:
    python -m repro_torch.launch.dryrun [--arch qwen2-72b] [--shape train_4k]
        [--mesh single|multi|both] [--mode mixed_ghost] [--out results/dryrun]
        [--no-calibrate] [--no-resume]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, torch_dtype
from repro_torch.configs.registry import ARCHS, build_model, get_arch
from repro_torch.kernels import dispatch, launches
from repro_torch.launch import analysis
from repro_torch.launch.flops import model_flops
from repro_torch.launch.mesh import (
    Mesh,
    fake_process_group,
    live_shape,
    make_mesh,
    make_production_mesh,
)
from repro_torch.optim import adam, warmup_cosine
from repro_torch.parallel import collectives
from repro_torch.parallel.fsdp import local_shape
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import flatten_dict, unflatten_dict

log = get_logger("dryrun")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def _mesh(multi_pod: bool, mesh_shape: Optional[tuple[int, int]]) -> Mesh:
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    return Mesh(("data", "model"), tuple(int(s) for s in mesh_shape))


def _shapes(tree: Any, placements: Any, mesh: Optional[Mesh]) -> dict[str, tuple]:
    """{path: shape} of each tensor of a tree on one rank of ``mesh`` under
    ``placements`` (None, or no mesh: whole); a placement shorter than its
    leaf (a batch's ``P(axes)``) leaves the other dims whole."""
    flat_p = flatten_dict(placements) if placements is not None and mesh is not None else {}
    out = {}
    for path, x in flatten_dict(tree).items():
        if isinstance(x, torch.Tensor):
            spec = tuple(flat_p.get(path, ())) + (None,) * x.ndim
            out[path] = local_shape(x.shape, spec[:x.ndim], mesh) if flat_p else tuple(x.shape)
    return out


def _local(tree: Any, placements: Any, mesh: Optional[Mesh]) -> Any:
    """Fake tensors at each leaf's shape on one rank of ``mesh`` (None: the
    full shapes), on the CPU device; non-tensor leaves as they are."""
    shapes = _shapes(tree, placements, mesh)
    return unflatten_dict({path: torch.empty(shapes[path], dtype=x.dtype) if path in shapes
                           else x for path, x in flatten_dict(tree).items()})


def leaf_bytes(tree: Any, placements: Any, mesh: Optional[Mesh]) -> dict[str, int]:
    """{path: bytes} one rank of ``mesh`` holds of each tensor of a tree of
    (meta) tensors under ``placements`` (None, or no mesh: whole)."""
    flat = flatten_dict(tree)
    return {path: math.prod(shape) * flat[path].element_size()
            for path, shape in _shapes(tree, placements, mesh).items()}


def train_arguments(model, cfg: Optional[ArchConfig], mesh: Mesh, abstract: dict,
                    batch: Any) -> tuple[dict, dict]:
    """(placements, {tree: {path: bytes}}) of a train step's arguments on one
    rank of ``mesh``: the parameters, the moments and the policy state of
    ``abstract`` (``abstract_train_state``) and the global ``batch``, under
    ``state_shardings`` and ``batch_shardings`` (whole on one device).  The
    step counter and the generator hold no device bytes."""
    from repro_torch.parallel.sharding import batch_shardings, state_shardings

    one = math.prod(mesh.axis_sizes) == 1
    state = None if one else state_shardings(model, mesh, cfg, abstract)
    trees = {"params": abstract["params"], "opt": abstract["opt"],
             "policy": abstract["policy"], "batch": batch}
    placements = {k: None if one else state[k] for k in ("params", "opt", "policy")}
    placements["batch"] = None if one else batch_shardings(batch, mesh, cfg)
    return placements, {k: leaf_bytes(trees[k], placements[k], mesh) for k in trees}


def _serve_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The global prompts (a prefill shape) or tokens ``{"t": (B, 1)}``."""
    from repro_torch.launch.specs import decode_token_specs, prefill_batch_specs

    b = shape.global_batch
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape, b)
    return {"t": decode_token_specs(b)}


def serve_arguments(model, cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> tuple[dict, dict]:
    """(placements, {tree: {path: bytes}}) of a prefill or decode step's
    arguments on one rank of ``mesh``: the parameters under
    ``param_shardings``, the serve state under ``local_serve_shardings``
    (the JAX rule with the port's divergences) and the global prompts or
    tokens under ``batch_shardings`` (whole on one device)."""
    from repro_torch.launch.flops import abstract_params
    from repro_torch.launch.specs import serve_state_specs
    from repro_torch.parallel.sharding import (
        batch_shardings,
        local_serve_shardings,
        param_shardings,
    )

    b = shape.global_batch
    trees = {"params": abstract_params(model),
             "state": serve_state_specs(model, cfg, shape, b),
             "batch": _serve_specs(cfg, shape)}
    placements = dict.fromkeys(trees)
    if math.prod(mesh.axis_sizes) > 1:
        placements = {"params": param_shardings(model, mesh, cfg, trees["params"]),
                      "state": local_serve_shardings(mesh, cfg, trees["state"], b),
                      "batch": batch_shardings(trees["batch"], mesh, cfg)}
    return placements, {k: leaf_bytes(trees[k], placements[k], mesh) for k in trees}


def _total(by_tree: dict, *names: str) -> int:
    return sum(sum(by_tree[k].values()) for k in names or by_tree)


def _folded(placements: Any) -> dict:
    """Placements of a (pod, data, model) mesh as the folded live mesh reads
    them: ("pod", "data") -> "data"; "pod" alone has no counterpart."""
    def entry(e):
        names = e if isinstance(e, tuple) else (e,)
        if "pod" not in names:
            return e
        if names[:2] != ("pod", "data"):
            return ("pod?",)
        rest = ("data",) + names[2:]
        return rest if len(rest) > 1 else rest[0]

    return {path: tuple(entry(e) for e in spec)
            for path, spec in flatten_dict(placements).items()}


def check_fold(on_mesh: Any, on_live: Any, mesh: Mesh) -> None:
    """The live mesh's placements equal the production mesh's with its pod
    axis folded into data (``launch.mesh``'s docstring), else raise."""
    if "pod" not in mesh.axis_names:
        return
    want, got = _folded(on_mesh), flatten_dict(on_live)
    bad = {path: (spec, got[path]) for path, spec in want.items() if got[path] != spec}
    if bad:
        raise ValueError(f"placements on {mesh.shape} do not fold pod into data: {bad}")


@contextlib.contextmanager
def _fleet(mesh: Mesh, target: str):
    """Fake tensors resolving as on ``target``, and (a mesh of more than one
    device) rank 0's live mesh over a fake process group; yields that mesh
    (None: one device)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if target not in ("cuda", "cpu"):
        raise ValueError(f"target {target!r}: 'cuda' (the card) or 'cpu'")
    world = math.prod(mesh.axis_sizes)
    with contextlib.ExitStack() as stack:
        live = None
        if world > 1:
            stack.enter_context(fake_process_group(world))
            live = make_mesh(live_shape(mesh), "cpu")
        stack.enter_context(FakeTensorMode())
        if target == "cuda":
            stack.enter_context(dispatch.abstract_cuda())
        yield live


def _run(make_step: Callable, args: tuple, *, live: Optional[Mesh], cfg, target: str) -> dict:
    """Run ``make_step()(*args)`` under the reshard rules of ``live``, the
    tracker, the collective record and the launch counts; the step's
    arguments are live from the start."""
    from repro_torch.parallel.reshard import use_reshard_rules

    tracker = analysis.MemoryTracker()
    tracker.add(args)
    launches.reset()
    rules = use_reshard_rules(live, cfg) if live is not None else contextlib.nullcontext()
    with rules:
        step = make_step()
        with collectives.recording() as record, tracker:
            out = step(*args)
    counts = launches.snapshot()
    impl = "fake" if target == "cuda" else "torch"
    outs, ins = analysis.tree_storage_bytes(out), analysis.tree_storage_bytes(args)
    return {
        "peak_bytes": tracker.peak,
        "largest_bytes": tracker.largest,
        "bytes_accessed": tracker.bytes_accessed,
        "ops": tracker.ops,
        "output_bytes": sum(outs.values()),
        "alias_bytes": sum(n for k, n in outs.items() if k in ins),
        "records": collectives.records(record),
        "launches": {k: v[impl] for k, v in counts.items()},
    }


def evaluate_train(
    build: Callable[[], Any], cfg: Optional[ArchConfig], mesh: Mesh,
    batch: Callable[[], dict], optimizer, *, mode: str = "mixed_ghost",
    schedule: Optional[Callable] = None, policy: Any = None, target: str = "cuda",
) -> dict:
    """Rank 0's ``make_train_step`` on ``mesh`` over fake tensors.

    ``build()`` makes the model on the CPU device and ``batch()`` the
    global batch (both are called under the fake mode); ``cfg`` the rules'
    configuration (None: a CNN's).  Returns the tracker's figures, the
    collective record ``(op, bytes, group size)``, the launches by kernel,
    ``argument_bytes`` (state and batch shards under the placements on
    ``mesh``: ``train_arguments``), ``state_bytes`` (the parameters' and
    moments' shards) and ``placements`` (None on one device)."""
    from repro_torch.launch.steps import DPTrainConfig, abstract_train_state, make_train_step
    from repro_torch.optim import constant
    from repro_torch.parallel.sharding import state_shardings
    from repro_torch.policies.fixed import FixedPolicy

    policy = policy or FixedPolicy(clip_norm=1.0)
    with _fleet(mesh, target) as live:
        model = build()
        abstract = abstract_train_state(model, optimizer, policy)
        gbatch = batch()
        placements, by_tree = train_arguments(model, cfg, mesh, abstract, gbatch)
        shardings, on = None, None
        if live is not None:
            shardings, on = state_shardings(model, live, cfg, abstract), mesh
            check_fold({k: placements[k] for k in ("params", "opt", "policy")},
                       {k: shardings[k] for k in ("params", "opt", "policy")}, mesh)
        state = {
            "params": _local(abstract["params"], placements["params"], on),
            "opt": _local(abstract["opt"], placements["opt"], on),
            "step": 0, "rng": abstract["rng"],
            "policy": _local(abstract["policy"], placements["policy"], on),
        }
        dp = DPTrainConfig(clipping_mode=mode, clip_norm=1.0, noise_multiplier=1.0,
                           logical_batch=int(flatten_dict(gbatch)["mask"].shape[0]),
                           policy=policy)
        res = _run(lambda: make_train_step(model, optimizer, schedule or constant(1e-3), dp,
                                           device="cpu", shardings=shardings),
                   (state, gbatch), live=live, cfg=cfg, target=target)
    res.update(argument_bytes=_total(by_tree), state_bytes=_total(by_tree, "params", "opt"),
               placements=placements)
    return res


def evaluate_serve(
    build: Callable[[], Any], cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
    target: str = "cuda",
) -> dict:
    """Rank 0's ``make_prefill_step`` (a prefill shape) or
    ``make_decode_step`` (a decode shape) on ``mesh`` over fake tensors:
    ``evaluate_train``'s figures (``serve_arguments``); ``state_bytes`` the
    parameters' and the serve state's shards."""
    from repro_torch.launch.flops import abstract_params
    from repro_torch.launch.specs import local_serve_state, serve_state_specs
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.parallel.sharding import local_serve_shardings, param_shardings

    b = shape.global_batch
    with _fleet(mesh, target) as live:
        model = build()
        placements, by_tree = serve_arguments(model, cfg, shape, mesh)
        shardings = on = None
        if live is not None:
            on = mesh
            check_fold(placements["params"], param_shardings(model, live, cfg), mesh)
            shardings = local_serve_shardings(live, cfg, serve_state_specs(model, cfg, shape, b),
                                              b)
            check_fold(placements["state"], shardings, mesh)
            state = local_serve_state(model, cfg, shape, b, shardings, live)
        else:
            state = model.init_state(b, shape.seq_len)
        params = _local(abstract_params(model), placements["params"], on)
        inputs = _local(_serve_specs(cfg, shape), None, None)
        if shape.kind == "prefill":
            make, args = make_prefill_step, (params, inputs, state)
        else:
            make, args = make_decode_step, (params, inputs["t"], state)
        res = _run(lambda: make(model, shardings), args, live=live, cfg=cfg, target=target)
    res.update(argument_bytes=_total(by_tree), state_bytes=_total(by_tree, "params", "state"),
               placements=placements)
    return res


def memory_stats(res: dict) -> dict:
    """The JAX ``memory_analysis`` keys from an evaluation (module docstring)."""
    peak, arg = res["peak_bytes"], res["argument_bytes"]
    out, alias = res["output_bytes"], res["alias_bytes"]
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": peak - arg - out + alias,
            "alias_bytes": alias, "peak_bytes_estimate": peak}


def analytic_flops(cfg: ArchConfig, shape: ShapeConfig, mode: str) -> dict:
    """The cell's analytic FLOPs (``launch.analytic``): the train step's from
    the taps discovered at the global batch on the ``meta`` device."""
    from repro_torch.core.clipping import discover_meta
    from repro_torch.launch.analytic import cell_flops, extra_fwd_flops, serve_matmul_flops
    from repro_torch.launch.flops import abstract_params
    from repro_torch.launch.specs import train_batch_specs

    model = build_model(cfg, device="meta")
    if shape.kind == "train":
        meta = discover_meta(model.loss_with_ctx, abstract_params(model),
                             train_batch_specs(cfg, shape, shape.global_batch))
        return cell_flops(meta, cfg, shape, mode).to_dict()
    fwd = serve_matmul_flops(model, cfg, shape) + extra_fwd_flops(cfg, shape)
    return {"fwd": fwd, "total": fwd, "norms": 0.0}


def _train_batch(cfg: ArchConfig, shape: ShapeConfig) -> Callable[[], dict]:
    from repro_torch.launch.specs import train_batch_specs

    return lambda: _local(train_batch_specs(cfg, shape, shape.global_batch), None, None)


def lower_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig], *,
               multi_pod: bool = False, mode: str = "mixed_ghost", calibrate: bool = True,
               mesh_shape: Optional[tuple[int, int]] = None,
               target: str = "cuda") -> tuple[Optional[dict], dict]:
    """Evaluate one cell; returns (the evaluation, its JSON dict).

    ``arch`` and ``shape`` are registry names or configurations;
    ``mesh_shape`` a ``(data, model)`` mesh in place of the production one;
    ``target`` "cuda" (the card's kernels) or "cpu" (the plain versions).
    ``calibrate`` is accepted and does nothing (module docstring)."""
    del calibrate
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = _mesh(multi_pod, mesh_shape)
    head = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name(mesh)}
    if not cfg.supports(shape):
        return None, {"status": "skipped", **head,
                      "reason": "full-attention arch: long_500k not runnable "
                                "(noted in DESIGN.md §Arch-applicability)"}
    build = lambda: build_model(cfg, device="cpu")
    if shape.kind == "train":
        res = evaluate_train(build, cfg, mesh, _train_batch(cfg, shape),
                             adam(state_dtype=torch_dtype(cfg.opt_state_dtype)), mode=mode,
                             schedule=warmup_cosine(1e-3, 100, 10000), target=target)
    else:
        res = evaluate_serve(build, cfg, shape, mesh, target=target)
    n_devices = math.prod(mesh.axis_sizes)
    colls = analysis.CollectiveStats.from_records(res["records"])
    flops = analytic_flops(cfg, shape, mode)
    mflops = model_flops(build_model(cfg, device="meta"), cfg, shape)
    terms = analysis.roofline_terms(
        memory_stats(res), n_devices=n_devices, flops_global=flops["total"],
        bytes_per_device=float(res["bytes_accessed"]),
        wire_bytes_per_device=colls.wire_bytes, model_flops=mflops)
    meta = {
        "status": "ok", **head,
        "n_devices": n_devices,
        "kind": shape.kind,
        "clipping_mode": mode if shape.kind == "train" else None,
        "analytic_flops": flops,
        "hlo_raw": {"bytes": float(res["bytes_accessed"]), "wire_bytes": colls.wire_bytes,
                    "collectives": colls.to_dict()},
        "roofline": terms.to_dict(),
        "calibrated": False,
        "launches": res["launches"],
    }
    return res, meta


def run_cell(arch_name, shape_name, *, multi_pod, mode, out_dir, resume=True,
             calibrate=True):
    sub = "multi" if multi_pod else "single"
    tag = f"{sub}/{arch_name}__{shape_name}"
    prior = pathlib.Path(out_dir) / sub / f"{arch_name}__{shape_name}.json"
    if resume and prior.exists():
        meta = json.loads(prior.read_text())
        if meta.get("status") in ("ok", "skipped"):
            log.info("%s: cached %s", tag, meta["status"])
            return meta
    t0 = time.time()
    try:
        res, meta = lower_cell(arch_name, shape_name, multi_pod=multi_pod, mode=mode,
                               calibrate=calibrate)
        if res is not None:
            mem = meta["roofline"]["memory_stats"]
            print(f"[{tag}] memory (predicted per rank): peak "
                  f"{mem['peak_bytes_estimate'] / 2**30:.2f} GiB (its largest allocation "
                  f"{res['largest_bytes'] / 2**30:.2f} GiB), arguments "
                  f"{mem['argument_bytes'] / 2**30:.2f} GiB; {res['ops']} ops, "
                  f"{res['bytes_accessed']:.3e} bytes accessed, "
                  f"{meta['hlo_raw']['wire_bytes']:.3e} wire bytes", flush=True)
    except Exception as e:  # noqa: BLE001 - any failure is a recorded bug
        meta = {
            "status": "error", "arch": arch_name, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    meta["elapsed_s"] = round(time.time() - t0, 1)
    out = pathlib.Path(out_dir) / sub
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch_name}__{shape_name}.json").write_text(json.dumps(meta, indent=2))
    status = meta["status"]
    extra = meta.get("error", "")[:140] if status == "error" else (
        meta.get("roofline", {}).get("bottleneck", "") if status == "ok" else
        meta.get("reason", ""))
    log.info("%s: %s (%.1fs) %s", tag, status, meta["elapsed_s"], extra)
    return meta


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="mixed_ghost")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    summary = []
    for multi in meshes:
        for a in archs:
            for s in shapes:
                meta = run_cell(a, s, multi_pod=multi, mode=args.mode, out_dir=args.out,
                                resume=not args.no_resume, calibrate=not args.no_calibrate)
                summary.append((a, s, meta["mesh"], meta["status"]))
    n_ok = sum(1 for *_, st in summary if st == "ok")
    n_skip = sum(1 for *_, st in summary if st == "skipped")
    n_err = len(summary) - n_ok - n_skip
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok / {n_skip} skipped / {n_err} errors "
          f"of {len(summary)} cells")
    for a, s, m, st in summary:
        if st == "error":
            print(f"  ERROR {m} {a} {s}")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
