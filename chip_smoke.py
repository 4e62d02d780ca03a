#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root; one CUDA device

Two main paths: VGG-19 (CIFAR-10 widths, 32x32, 10 classes, GroupNorm,
fp32) at batch 128, and ViT-Base/16 (12 layers, d_model 768, 224x224,
10 classes, bf16 compute with fp32 parameters) at batch 32.  Phases, in
order; any failure exits non-zero and prints no result:

1. card     the name and power limit, as nvidia-smi reports them;
2. build    the CUDA kernels from src/repro_torch/csrc with nvcc (timed);
3. kernels  each CUDA kernel against its plain PyTorch version on the card,
            at the shapes and dtypes both training steps give it (taken
            from the models' own taps) and at ragged small shapes (T = 1, T
            off the tile, D and p off the tile, repeated ids, bf16), with
            CUDA-event times of the kernel, the plain version and one
            PyTorch library call that computes the same function (a
            yardstick the port never calls);
4. slice    per path, DP-SGD steps through make_train_step in non_private,
            mixed_ghost and bk_mixed: loss, kernel launches per step against
            the taps' expectation, step time (median and quartiles), peak
            memory, and one profiled step's device busy time and idle
            share.  The launch counts are zeroed just before each path's
            steps and read just after them;
5. compare  per path, one clipped step's per-sample norms and gradient sum
            on the kernels against the plain versions (force_impl("torch"))
            on the same card, and mixed_ghost against bk_mixed.

TF32 is off for cuDNN convolutions and for matmuls throughout, so the fp32
comparisons are in full fp32.  Details go to chiprun_out/chip_smoke.json.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet, dense): the least time a
# function can take is the larger of bytes / HBM rate and operations /
# the peak rate of their operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

MODES = ("non_private", "mixed_ghost", "bk_mixed")
STEPS = 10  # timed steps per mode and path

# relative tolerances of a kernel against its plain version (max |kernel -
# plain| / max |plain|): both sides sum the same fp32 products in
# different orders
TOL = {"ghost_norm_sq": 1e-4, "embedding_ghost_norm_sq": 1e-4,
       "book_weighted_grad": 1e-4, "psg_contract": 1e-5}
NORM_TOL = 1e-4  # per-sample norms, kernels vs plain and mixed_ghost vs bk_mixed
# clipped gradient sums, relative to the largest entry.  The kernel path
# against force_impl("torch") runs the same step with only the kernels'
# fp32 summation order changed, in either dtype (readings up to 2e-6)
KERNEL_GRAD_TOL = 1e-4
# mixed_ghost against bk_mixed: fp32 steps differ only in summation order;
# bf16 steps compare mixed_ghost's bf16 weight gradients of the second
# backward (each weighted cotangent rounded to about 2^-9) with bk_mixed's
# fp32 contractions of the stored activations
MODE_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

KERNEL_INFO = {
    "ghost_norm_sq": ("src/repro_torch/csrc/ghost_norm.cu",
                      "src/repro/kernels/ghost_norm/ghost_norm.py:48"),
    "embedding_ghost_norm_sq": ("src/repro_torch/csrc/ghost_norm.cu",
                                "src/repro/kernels/ghost_norm/ghost_norm.py:135"),
    "book_weighted_grad": ("src/repro_torch/csrc/book_weighted_grad.cu",
                           "src/repro/kernels/psg_contract/psg_contract.py:48"),
    "psg_contract": ("src/repro_torch/csrc/psg_contract.cu",
                     "src/repro/kernels/psg_contract/psg_contract.py:110"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phases --
def phase_card() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return {"nvidia_smi": line, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def phase_build() -> dict:
    from repro_torch.kernels import build

    info = build.build(force=True)
    build.library()
    print(f"build: {info.seconds:.1f} s -> {info.path.relative_to(ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"  {line.strip()}")
    return {"seconds": info.seconds, "path": str(info.path.relative_to(ROOT))}


def main_path_shapes(model, params, batch) -> tuple[dict, dict]:
    """Kernel call shapes and dtypes of one training step, with their calls
    per step, and the kernel launches per step of each mode, from the
    model's own taps and the layerwise decisions.

    A stacked tap (ViT layers) launches its norm kernel once per layer and
    its book or bank contraction once for all layers.  The norm kernels get
    the activation in the model dtype and the cotangent in fp32; the book
    holds both in the model dtype; banked per-sample gradients are fp32.
    """
    from repro_torch.core.clipping import discover_meta
    from repro_torch.core.decision import decide
    from repro_torch.core.ghost import psg_param_shape

    meta = discover_meta(model.loss_with_ctx, params, batch)
    shapes = {k: {} for k in KERNEL_INFO}
    expected = {mode: dict.fromkeys(KERNEL_INFO, 0.0) for mode in MODES}

    def add(kernel, shape, dtypes, calls=1):
        key = (shape, dtypes)
        shapes[kernel][key] = shapes[kernel].get(key, 0) + calls

    for m in meta.values():
        b, layers = m.batch_size, m.n_stack
        a_dt, s_dt = _name(m.a_dtype), _name(m.s_dtype)
        if m.kind == "embedding":
            add("embedding_ghost_norm_sq", (b * layers, m.T, m.p, m.D), (a_dt, "float32"))
            for mode in ("mixed_ghost", "bk_mixed"):
                expected[mode]["embedding_ghost_norm_sq"] += layers
            continue
        if m.kind == "matmul" and decide(m, mode="mixed_ghost") == "ghost":
            add("ghost_norm_sq", (b, m.T, m.D, m.p), (a_dt, "float32"), layers)
            expected["mixed_ghost"]["ghost_norm_sq"] += layers
        if m.kind == "matmul" and decide(m, mode="bk_mixed") == "ghost":
            expected["bk_mixed"]["ghost_norm_sq"] += layers
            expected["bk_mixed"]["book_weighted_grad"] += 1
            add("book_weighted_grad", (layers, b * m.T, m.D, m.p), (a_dt, s_dt))
        else:
            add("psg_contract", (b, layers * math.prod(psg_param_shape(m))), ("float32",))
            expected["bk_mixed"]["psg_contract"] += 1
            if m.bias_path is not None:
                add("psg_contract", (b, layers * m.p), ("float32",))
                expected["bk_mixed"]["psg_contract"] += 1
    return shapes, expected


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _bound(kernel: str, shape, dtypes, segments: int = 0) -> tuple[float, str]:
    """Least time (ms) of one call: max(bytes / HBM rate, operations / the
    peak rate of their type), and which of the two bounds it.  ``segments``
    (embedding only): the distinct ids of this call's data, summed over
    samples."""
    import torch

    size = {name: torch.empty((), dtype=getattr(torch, name)).element_size()
            for name in set(dtypes)}
    rate = PEAK_FLOPS_PER_S
    fp32 = rate["float32"]
    if kernel == "ghost_norm_sq":  # two lower-triangle Grams, then their dot
        n, t, d, p = shape
        ops_s = (n * t * (t + 1) * d / rate[dtypes[0]] + n * t * (t + 1) * p / rate[dtypes[1]]
                 + 2 * n * t * t / fp32)
        nbytes = n * t * (d * size[dtypes[0]] + p * size[dtypes[1]]) + 4 * n
    elif kernel == "embedding_ghost_norm_sq":
        # least work: out[n] = sum_v |sum_{t: id_t = v} g_t|^2, a segment sum
        # of g's rows (an add per row beyond its segment's first), then a
        # square and an add per entry of each segment's sum
        n, t, p, _ = shape
        ops_s = ((n * t - segments) * p + 2 * segments * p) / fp32
        nbytes = n * t * (size[dtypes[0]] + p * size[dtypes[1]]) + 4 * n
    elif kernel == "book_weighted_grad":  # a row-scaled GEMM per m
        m, r, d, p = shape
        kind = "bfloat16" if set(dtypes) == {"bfloat16"} else "float32"
        ops_s = (2 * m * r * d * p) / rate[kind] + m * r * p / fp32
        nbytes = m * r * (d * size[dtypes[0]] + p * size[dtypes[1]] + 4) + 4 * m * d * p
    else:
        n, f = shape
        ops_s = 2 * n * f / fp32
        nbytes = n * f * size[dtypes[0]] + 4 * (n + f)
    t_ops, t_bytes = ops_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _segments(ids) -> int:
    """Distinct ids per sample, summed over the samples of ``ids`` (N, T)."""
    s = ids.sort(dim=1).values
    return int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum())


def _kernel_case(kernel: str, shape, dtypes, gen, timed: bool) -> dict:
    import torch

    from repro_torch.kernels.ghost_norm import ghost_norm as gn
    from repro_torch.kernels.psg_contract import psg_contract as pc

    dev = torch.device("cuda")
    dt = [getattr(torch, name) for name in dtypes]

    def rnd(dtype, *s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    if kernel == "ghost_norm_sq":
        n, t, d, p = shape
        args = (rnd(dt[0], n, t, d), rnd(dt[1], n, t, p))
        kern, plain = gn.ghost_norm_sq_cuda, gn.ghost_norm_sq_plain

        def library(a, g):
            return (torch.bmm(a, a.mT) * torch.bmm(g, g.mT)).sum(dim=(1, 2))
    elif kernel == "embedding_ghost_norm_sq":
        n, t, p, vocab = shape  # vocab == T: the position ids arange(T)
        if vocab == t:
            ids = torch.arange(t, device=dev).expand(n, t)
        else:
            ids = torch.randint(0, vocab, (n, t), generator=gen, device=dev)
        args = (ids.to(dt[0]).contiguous(), rnd(dt[1], n, t, p))
        kern, plain = gn.embedding_ghost_norm_sq_cuda, gn.embedding_ghost_norm_sq_plain

        def library(ids, g):
            return (torch.bmm(g, g.mT) * (ids[:, :, None] == ids[:, None, :])).sum(dim=(1, 2))
    elif kernel == "book_weighted_grad":
        m, r, d, p = shape
        args = (rnd(dt[0], m, r, d), rnd(dt[1], m, r, p),
                torch.rand(m, r, generator=gen, device=dev))
        kern, plain = pc.book_weighted_grad_cuda, pc.book_weighted_grad_plain

        def library(a, g, w):
            return torch.einsum("mrd,mr,mrp->mdp", a, w, g)
    else:
        n, f = shape
        args = (rnd(dt[0], n, f), torch.rand(n, generator=gen, device=dev))
        kern, plain = pc.psg_contract_cuda, pc.psg_contract_plain

        def library(psg, c):
            return c @ psg

    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{kernel} {shape}: non-finite output")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    again = kern(*args)
    case = {
        "shape": list(shape), "dtypes": list(dtypes),
        "max_abs_err": abs_err, "rel_err": rel_err, "tol": TOL[kernel],
        "deterministic": bool(torch.equal(got, again)),
    }
    if timed:
        iters = 20
        case["ms"] = cuda_ms(lambda: kern(*args), iters)
        case["plain_ms"] = cuda_ms(lambda: plain(*args), iters)
        lib_args = tuple(x.float() if x.is_floating_point() else x for x in args)
        case["library_ms"] = cuda_ms(lambda: library(*lib_args), iters)
        segments = _segments(args[0]) if kernel == "embedding_ghost_norm_sq" else 0
        case["bound_ms"], case["bound_by"] = _bound(kernel, shape, dtypes, segments)
    status = "ok" if rel_err <= TOL[kernel] else "MISMATCH"
    timing = (f" ms={case['ms']:.4f} plain={case['plain_ms']:.4f} "
              f"library={case['library_ms']:.4f} bound={case['bound_ms']:.4f}"
              if timed else "")
    print(f"  {kernel} {tuple(shape)} {'/'.join(dtypes)}: rel_err={rel_err:.2e} "
          f"(tol {TOL[kernel]:.0e}) deterministic={case['deterministic']}{timing} {status}")
    require(rel_err <= TOL[kernel], f"{kernel} {shape} {dtypes}: rel err {rel_err:.3e}")
    require(case["deterministic"], f"{kernel} {shape} {dtypes}: repeated calls differ")
    return case


FLOAT_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32")]
RAGGED = {
    "ghost_norm_sq": [((3, 37, 33, 7), FLOAT_PAIRS), ((2, 1, 5, 3), FLOAT_PAIRS),
                      ((4, 100, 130, 70), FLOAT_PAIRS), ((2, 17, 1, 40), FLOAT_PAIRS)],
    # (N, T, p, vocab): repeated ids, T off the tile, T = 1, several tiles
    "embedding_ghost_norm_sq": [
        (shape, [("int64", "float32"), ("int32", "bfloat16")])
        for shape in ((3, 37, 33, 5), (4, 100, 70, 1000), (2, 1, 10, 3),
                      (5, 16, 130, 4), (2, 300, 64, 50))
    ],
    "book_weighted_grad": [((3, 37, 33, 130), FLOAT_PAIRS[:2]), ((1, 1, 5, 3), FLOAT_PAIRS[:2]),
                           ((2, 100, 70, 9), FLOAT_PAIRS)],
    "psg_contract": [(shape, [("float32",), ("bfloat16",)])
                     for shape in ((5, 33), (1, 1), (7, 1000), (130, 257))],
}


def phase_kernels(paths: dict) -> dict:
    """Every kernel at every path's main shapes (timed), then the ragged ones."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for kernel in KERNEL_INFO:
        cases = []
        for tag, path in paths.items():
            if not path["shapes"][kernel]:
                continue
            print(f"kernel {kernel}: {tag} main-path shapes (calls per step)")
            for (shape, dtypes), calls in sorted(path["shapes"][kernel].items()):
                case = _kernel_case(kernel, shape, dtypes, gen, timed=True)
                case["path"], case["calls_per_step"] = tag, calls
                cases.append(case)
        print(f"kernel {kernel}: ragged shapes")
        for shape, dtype_sets in RAGGED[kernel]:
            for dtypes in dtype_sets:
                cases.append(_kernel_case(kernel, shape, dtypes, gen, timed=False))
        out[kernel] = cases
    return out


def _profiled_step(step, state, batch, median_ms: float) -> dict:
    """One more step under torch.profiler: device busy time by kernel name.

    The profiler's host-side tracing slows the step's wall clock, so the
    device's idle share is taken against the median of the unprofiled
    steps: 1 - device busy ms / median step ms.  The traced wall time is
    kept only to report that overhead.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    idle = 1 - busy / median_ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  traced step: device busy {busy:.2f} ms of a {median_ms:.2f} ms median step "
          f"(idle share {idle:.2f}); traced wall {wall_ms:.2f} ms "
          f"({wall_ms / median_ms:.2f}x the median, profiler overhead); "
          "top kernels by device time:")
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:100]}")
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": idle, "top": top}


def phase_slice(tag: str, path: dict, n_steps: int) -> dict:
    import torch

    from repro_torch.data.synthetic import synthetic_vision_batch
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import DPTrainConfig, make_train_state, make_train_step
    from repro_torch.optim import constant, sgd

    model, batch_size, expected = path["build"](), path["batch"], path["expected"]
    dev = model.device
    batches = [
        synthetic_vision_batch(batch=batch_size, image=path["image"], channels=3,
                               n_classes=10, step=i, device=dev)
        for i in range(n_steps + 1)
    ]
    out = {}
    launches.reset()  # this path's counts start here ...
    for mode in MODES:
        opt = sgd(momentum=0.9)
        state = make_train_state(model, 0, opt)
        step = make_train_step(
            model, opt, constant(path["lr"][mode]),
            DPTrainConfig(clipping_mode=mode, clip_norm=1.0, noise_multiplier=1.0,
                          logical_batch=batch_size),
            device=dev,
        )
        state, _ = step(state, batches[0])  # warm-up (cuDNN plans, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launches.snapshot()
        times, losses = [], []
        for i in range(1, n_steps + 1):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        after = launches.snapshot()
        peak = torch.cuda.max_memory_allocated()
        median = statistics.median(times)
        q1, _, q3 = statistics.quantiles(times, n=4)
        trace = _profiled_step(step, state, batches[0], median)
        per_step = {
            k: (after[k]["cuda"] - before[k]["cuda"]) / n_steps for k in KERNEL_INFO
        }
        plain_calls = sum(after[k]["torch"] - before[k]["torch"] for k in KERNEL_INFO)
        print(f"slice {tag} {mode}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"step ms median {median:.2f} (q1 {q1:.2f}, q3 {q3:.2f}), "
              f"peak memory {peak / 2**20:.1f} MiB, kernel launches per step {per_step}")
        require(all(math.isfinite(x) for x in losses), f"{tag} {mode}: non-finite loss")
        require(plain_calls == 0, f"{tag} {mode}: {plain_calls} plain-version calls on the card")
        require(per_step == expected[mode],
                f"{tag} {mode}: launches per step {per_step}, expected {expected[mode]}")
        out[mode] = {"losses": losses, "step_ms": times, "median_step_ms": median,
                     "q1_step_ms": q1, "q3_step_ms": q3, "peak_bytes": peak,
                     "launches_per_step": per_step, "trace": trace}
    counts = launches.snapshot()  # ... and are read here
    out["launches"] = {k: counts[k]["cuda"] for k in KERNEL_INFO}
    for kernel in KERNEL_INFO:
        wanted = any(expected[mode][kernel] for mode in MODES)
        require(not wanted or out["launches"][kernel] > 0,
                f"{tag}: {kernel} was never launched on its main path")
    return out


def _max_rel(x, y) -> float:
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


def phase_compare(tag: str, path: dict) -> dict:
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.kernels import dispatch
    from repro_torch.utils.tree import flatten_dict

    model, params, batch = _model_params_batch(path)
    runs = {}
    for mode in ("mixed_ghost", "bk_mixed"):
        fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, clip_norm=1.0))
        runs[(mode, "cuda")] = fn(params, batch)
        with dispatch.force_impl("torch"):
            runs[(mode, "torch")] = fn(params, batch)
    out = {}
    pairs = [
        (("mixed_ghost", "cuda"), ("mixed_ghost", "torch"), KERNEL_GRAD_TOL),
        (("bk_mixed", "cuda"), ("bk_mixed", "torch"), KERNEL_GRAD_TOL),
        (("mixed_ghost", "cuda"), ("bk_mixed", "cuda"), MODE_GRAD_TOL[path["dtype"]]),
    ]
    for got_key, ref_key, grad_tol in pairs:
        _, g_got, aux_got = runs[got_key]
        _, g_ref, aux_ref = runs[ref_key]
        norm_err = _max_rel(aux_got["per_sample_norms"], aux_ref["per_sample_norms"])
        flat_got, flat_ref = flatten_dict(g_got), flatten_dict(g_ref)
        scale = max(float(v.abs().max()) for v in flat_ref.values())
        grad_err = max(float((flat_got[k] - v).abs().max()) for k, v in flat_ref.items()) / scale
        name = f"{tag} {'/'.join(got_key)} vs {'/'.join(ref_key)}"
        print(f"compare {name}: norms rel err {norm_err:.2e} (tol {NORM_TOL:.0e}), "
              f"clipped grad sum rel err {grad_err:.2e} (tol {grad_tol:.0e})")
        require(norm_err <= NORM_TOL, f"{name}: norms differ by {norm_err:.3e}")
        require(grad_err <= grad_tol, f"{name}: clipped gradients differ by {grad_err:.3e}")
        out[name] = {"norm_rel_err": norm_err, "grad_rel_err": grad_err, "grad_tol": grad_tol}
    return out


def summary_line(kernels: dict, slices: dict) -> dict:
    """Per kernel: times and bound summed over the calls at the main-path
    shapes of one training step of each path that launches it (the step of
    the mode that launches it: ghost norms mixed_ghost, the contractions
    bk_mixed); launches summed over the paths' runs."""
    rows = []
    for kernel, (source, replaces) in KERNEL_INFO.items():
        main = [c for c in kernels[kernel] if "calls_per_step" in c]
        total = {key: sum(c[key] * c["calls_per_step"] for c in main)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(c["bound_ms"] * c["calls_per_step"] for c in main
                     if c["bound_by"] == "operations")
        rows.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(out["launches"][kernel] for out in slices.values()),
            "max_abs_err": max(c["max_abs_err"] for c in main),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations" if by_ops >= total["bound_ms"] / 2 else "bytes",
            "library_ms": total["library_ms"],
        })
    return {"kernels": rows}


def _model_params_batch(path: dict):
    """A path's model, its parameters from seed 0 and the batch of step 0."""
    import torch

    from repro_torch.data.synthetic import synthetic_vision_batch

    model = path["build"]()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = synthetic_vision_batch(batch=path["batch"], image=path["image"], channels=3,
                                   n_classes=10, step=0, device="cuda")
    return model, params, batch


def _paths() -> dict:
    """The two main paths, with the kernel shapes and expected launches of
    their taps.  Each phase builds a path's model anew (seed 0) and drops it
    after, so one path's memory never counts in the other's peak."""
    from repro_torch.configs.paper_native import VIT_BASE
    from repro_torch.models.cnn import VGG
    from repro_torch.models.vit import ViT

    specs = {
        # the paper's Table 6 batch; DP modes step on the privatized mean of
        # gradients clipped to norm 1, non_private (as in the JAX package) on
        # the plain sum of unclipped gradients (per-sample norms ~200 at init)
        "vgg19": dict(build=lambda: VGG("vgg19", device="cuda"), batch=128, image=32,
                      lr={"non_private": 0.05 / (128 * 200), "mixed_ghost": 0.05,
                          "bk_mixed": 0.05}),
        # ViT-Base/16 on CIFAR-10 upscaled to 224, as the paper fine-tunes
        # its ViTs; small learning rates keep 86M noisy coordinates finite
        "vit_base": dict(build=lambda: ViT(VIT_BASE, image_size=224, patch=16, n_classes=10,
                                           device="cuda"),
                         batch=32, image=224,
                         lr={"non_private": 1e-3 / 32, "mixed_ghost": 1e-3,
                             "bk_mixed": 1e-3}),
    }
    for tag, path in specs.items():
        model, params, batch = _model_params_batch(path)
        path["dtype"] = _name(model.dtype)
        path["shapes"], path["expected"] = main_path_shapes(model, params, batch)
        print(f"{tag} at batch {path['batch']} ({path['dtype']} compute): "
              f"expected kernel launches per step {path['expected']}")
    return specs


def run() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for cuDNN and matmuls: fp32 comparisons in full fp32")
    card = phase_card()
    build = phase_build()
    paths = _paths()
    kernels = phase_kernels(paths)
    slices = {tag: phase_slice(tag, path, STEPS) for tag, path in paths.items()}
    compare = {tag: phase_compare(tag, path) for tag, path in paths.items()}
    summary = summary_line(kernels, slices)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build": build, "steps": STEPS,
        "paths": {tag: {"batch": path["batch"], "image": path["image"],
                        "dtype": path["dtype"], "expected": path["expected"]}
                  for tag, path in paths.items()},
        "kernels": kernels, "slice": slices, "compare": compare, "summary": summary,
    }, indent=1))
    return {"summary": summary, "card": card}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from the "
              "repository checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        result = run()
    except Exception:  # report any failed phase and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps(result["summary"]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": result["card"]["name"], "count": result["card"]["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
