#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root; one CUDA device

Phases, in order; any failure exits non-zero and prints no result:

1. card     the name and power limit, as nvidia-smi reports them;
2. build    the CUDA kernels from src/repro_torch/csrc with nvcc (timed);
3. kernels  each CUDA kernel against its plain PyTorch version on the card,
            at the VGG-19 batch-128 shapes of the training step (taken from
            the model's own taps) and at ragged small shapes (T = 1, T off
            the tile, D and p off the tile, bf16), with CUDA-event times of
            the kernel, the plain version and one PyTorch library call that
            computes the same function (a yardstick the port never calls);
4. slice    VGG-19 (CIFAR-10 widths, 32x32, 10 classes, GroupNorm) DP-SGD
            steps through make_train_step at batch 128 in non_private,
            mixed_ghost and bk_mixed: loss, kernel launches per step, median
            step time, peak memory.  Launch counts are zeroed just before
            this phase and read just after it;
5. compare  one clipped step's per-sample norms and gradient sum on the
            kernels against the plain versions (force_impl("torch")) on the
            same card, and mixed_ghost against bk_mixed.

TF32 is off for cuDNN convolutions and for matmuls throughout, so every
comparison is in full fp32.  Details go to chiprun_out/chip_smoke.json.
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
# function can take is the larger of bytes / HBM rate and flops / fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MODES = ("non_private", "mixed_ghost", "bk_mixed")
BATCH = 128  # physical batch of the paper's Table 6
STEPS = 10  # timed steps per mode

# relative tolerances (max |kernel - plain| / max |plain|): both sides sum
# the same fp32 products in different orders
TOL = {"ghost_norm_sq": 1e-4, "book_weighted_grad": 1e-4, "psg_contract": 1e-5}
NORM_TOL = 1e-4  # per-sample norms, kernels vs plain and mixed_ghost vs bk_mixed
GRAD_TOL = 1e-4  # clipped gradient sums, relative to the largest entry

KERNEL_INFO = {
    "ghost_norm_sq": ("src/repro_torch/csrc/ghost_norm.cu",
                      "src/repro/kernels/ghost_norm/ghost_norm.py:48"),
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


def main_path_shapes(model, params, batch) -> dict:
    """Kernel call shapes (and calls per step) of the VGG-19 training step,
    from the model's own taps and the layerwise decisions."""
    from repro_torch.core.clipping import discover_meta
    from repro_torch.core.decision import decide
    from repro_torch.core.ghost import psg_param_shape

    meta = discover_meta(model.loss_with_ctx, params, batch)
    shapes = {k: {} for k in KERNEL_INFO}

    def add(kernel, shape):
        shapes[kernel][shape] = shapes[kernel].get(shape, 0) + 1

    for m in meta.values():
        b = m.batch_size
        if m.kind == "matmul" and decide(m, mode="mixed_ghost") == "ghost":
            add("ghost_norm_sq", (b, m.T, m.D, m.p))
        if m.kind == "matmul" and decide(m, mode="bk_mixed") == "ghost":
            add("book_weighted_grad", (1, b * m.T, m.D, m.p))
        else:
            add("psg_contract", (b, math.prod(psg_param_shape(m))))
            if m.bias_path is not None:
                add("psg_contract", (b, m.p))
    return shapes


def _flops_bytes(kernel: str, shape) -> tuple[float, float]:
    if kernel == "ghost_norm_sq":
        n, t, d, p = shape
        return n * t * (t + 1) * (d + p) + 2 * n * t * t, 4 * (n * t * (d + p) + n)
    if kernel == "book_weighted_grad":
        m, r, d, p = shape
        return 2 * m * r * d * p + m * r * p, 4 * (m * r * (d + p + 1) + m * d * p)
    n, f = shape
    return 2 * n * f, 4 * (n * f + n + f)


def _kernel_case(kernel: str, shape, dtype, gen, timed: bool) -> dict:
    import torch

    from repro_torch.kernels.ghost_norm import ghost_norm as gn
    from repro_torch.kernels.psg_contract import psg_contract as pc

    dev = torch.device("cuda")

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=dev).to(dtype)

    if kernel == "ghost_norm_sq":
        n, t, d, p = shape
        args = (rnd(n, t, d), rnd(n, t, p))
        kern, plain = gn.ghost_norm_sq_cuda, gn.ghost_norm_sq_plain

        def library(a, g):
            return (torch.bmm(a, a.mT) * torch.bmm(g, g.mT)).sum(dim=(1, 2))
    elif kernel == "book_weighted_grad":
        m, r, d, p = shape
        args = (rnd(m, r, d), rnd(m, r, p), torch.rand(m, r, generator=gen, device=dev))
        kern, plain = pc.book_weighted_grad_cuda, pc.book_weighted_grad_plain

        def library(a, g, w):
            return torch.einsum("mrd,mr,mrp->mdp", a, w, g)
    else:
        n, f = shape
        args = (rnd(n, f), torch.rand(n, generator=gen, device=dev))
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
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": abs_err, "rel_err": rel_err, "tol": TOL[kernel],
        "deterministic": bool(torch.equal(got, again)),
    }
    if timed:
        iters = 20
        case["ms"] = cuda_ms(lambda: kern(*args), iters)
        case["plain_ms"] = cuda_ms(lambda: plain(*args), iters)
        lib_args = tuple(x.float() for x in args)
        case["library_ms"] = cuda_ms(lambda: library(*lib_args), iters)
        flops, nbytes = _flops_bytes(kernel, shape)
        t_ops, t_bytes = flops / FP32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        case["bound_ms"] = max(t_ops, t_bytes)
        case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    status = "ok" if rel_err <= TOL[kernel] else "MISMATCH"
    timing = (f" ms={case['ms']:.4f} plain={case['plain_ms']:.4f} "
              f"library={case['library_ms']:.4f} bound={case['bound_ms']:.4f}"
              if timed else "")
    print(f"  {kernel} {tuple(shape)} {case['dtype']}: rel_err={rel_err:.2e} "
          f"(tol {TOL[kernel]:.0e}) deterministic={case['deterministic']}{timing} {status}")
    require(rel_err <= TOL[kernel], f"{kernel} {shape} {dtype}: rel err {rel_err:.3e}")
    return case


RAGGED = {
    "ghost_norm_sq": [(3, 37, 33, 7), (2, 1, 5, 3), (4, 100, 130, 70), (2, 17, 1, 40)],
    "book_weighted_grad": [(3, 37, 33, 130), (1, 1, 5, 3), (2, 100, 70, 9)],
    "psg_contract": [(5, 33), (1, 1), (7, 1000), (130, 257)],
}


def phase_kernels(shapes: dict) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for kernel in KERNEL_INFO:
        print(f"kernel {kernel}: main-path shapes (calls per step)")
        cases = []
        for shape, calls in sorted(shapes[kernel].items()):
            case = _kernel_case(kernel, shape, torch.float32, gen, timed=True)
            case["calls_per_step"] = calls
            cases.append(case)
        print(f"kernel {kernel}: ragged shapes")
        for shape in RAGGED[kernel]:
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(_kernel_case(kernel, shape, dtype, gen, timed=False))
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


def phase_slice(model, batch_size: int, n_steps: int, expected: dict) -> dict:
    import torch

    from repro_torch.data.synthetic import synthetic_vision_batch
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import DPTrainConfig, make_train_state, make_train_step
    from repro_torch.optim import constant, sgd

    dev = model.device
    batches = [
        synthetic_vision_batch(batch=batch_size, image=32, channels=3, n_classes=10,
                               step=i, device=dev)
        for i in range(n_steps + 1)
    ]
    out = {}
    launches.reset()  # the main path's counts start here ...
    for mode in MODES:
        opt = sgd(momentum=0.9)
        state = make_train_state(model, 0, opt)
        # the DP modes step on the privatized mean of gradients clipped to
        # norm 1; non_private, as in the JAX package, on the plain sum over
        # the batch of unclipped gradients (per-sample norms ~200 at init)
        lr = 0.05 / (batch_size * 200) if mode == "non_private" else 0.05
        step = make_train_step(
            model, opt, constant(lr),
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
        trace = _profiled_step(step, state, batches[0], statistics.median(times))
        per_step = {
            k: (after[k]["cuda"] - before[k]["cuda"]) / n_steps for k in KERNEL_INFO
        }
        plain_calls = sum(after[k]["torch"] - before[k]["torch"] for k in KERNEL_INFO)
        peak = torch.cuda.max_memory_allocated()
        print(f"slice {mode}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"median step {statistics.median(times):.2f} ms, "
              f"peak memory {peak / 2**20:.1f} MiB, kernel launches per step {per_step}")
        require(all(math.isfinite(x) for x in losses), f"{mode}: non-finite loss")
        require(plain_calls == 0, f"{mode}: {plain_calls} plain-version calls on the card")
        require(per_step == expected[mode],
                f"{mode}: launches per step {per_step}, expected {expected[mode]}")
        out[mode] = {"losses": losses, "step_ms": times,
                     "median_step_ms": statistics.median(times), "peak_bytes": peak,
                     "launches_per_step": per_step, "trace": trace}
    counts = launches.snapshot()  # ... and are read here
    out["launches"] = {k: counts[k]["cuda"] for k in KERNEL_INFO}
    return out


def _max_rel(x, y) -> float:
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


def phase_compare(model, params, batch) -> dict:
    from repro_torch.core.clipping import ClipConfig, dp_value_and_clipped_grad
    from repro_torch.kernels import dispatch
    from repro_torch.utils.tree import flatten_dict

    runs = {}
    for mode in ("mixed_ghost", "bk_mixed"):
        fn = dp_value_and_clipped_grad(model.loss_with_ctx, ClipConfig(mode=mode, clip_norm=1.0))
        runs[(mode, "cuda")] = fn(params, batch)
        with dispatch.force_impl("torch"):
            runs[(mode, "torch")] = fn(params, batch)
    out = {}
    pairs = [
        (("mixed_ghost", "cuda"), ("mixed_ghost", "torch")),
        (("bk_mixed", "cuda"), ("bk_mixed", "torch")),
        (("mixed_ghost", "cuda"), ("bk_mixed", "cuda")),
    ]
    for got_key, ref_key in pairs:
        _, g_got, aux_got = runs[got_key]
        _, g_ref, aux_ref = runs[ref_key]
        norm_err = _max_rel(aux_got["per_sample_norms"], aux_ref["per_sample_norms"])
        flat_got, flat_ref = flatten_dict(g_got), flatten_dict(g_ref)
        scale = max(float(v.abs().max()) for v in flat_ref.values())
        grad_err = max(float((flat_got[k] - v).abs().max()) for k, v in flat_ref.items()) / scale
        name = f"{'/'.join(got_key)} vs {'/'.join(ref_key)}"
        print(f"compare {name}: norms rel err {norm_err:.2e} (tol {NORM_TOL:.0e}), "
              f"clipped grad sum rel err {grad_err:.2e} (tol {GRAD_TOL:.0e})")
        require(norm_err <= NORM_TOL, f"{name}: norms differ by {norm_err:.3e}")
        require(grad_err <= GRAD_TOL, f"{name}: clipped gradients differ by {grad_err:.3e}")
        out[name] = {"norm_rel_err": norm_err, "grad_rel_err": grad_err}
    return out


def summary_line(kernels: dict, slice_out: dict) -> dict:
    """Per kernel: times and bound summed over one training step's calls at
    the main-path shapes (the step of the mode that launches it)."""
    rows = []
    for kernel, (source, replaces) in KERNEL_INFO.items():
        main = [c for c in kernels[kernel] if "calls_per_step" in c]
        total = {key: sum(c[key] * c["calls_per_step"] for c in main)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(c["bound_ms"] * c["calls_per_step"] for c in main
                     if c["bound_by"] == "operations")
        rows.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": slice_out["launches"][kernel],
            "max_abs_err": max(c["max_abs_err"] for c in main),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations" if by_ops >= total["bound_ms"] / 2 else "bytes",
            "library_ms": total["library_ms"],
        })
    return {"kernels": rows}


def run() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for cuDNN and matmuls: all comparisons in fp32")
    card = phase_card()
    build = phase_build()

    from repro_torch.data.synthetic import synthetic_vision_batch
    from repro_torch.models.cnn import VGG

    model = VGG("vgg19", device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = synthetic_vision_batch(batch=BATCH, image=32, channels=3, n_classes=10,
                                   step=0, device="cuda")
    shapes = main_path_shapes(model, params, batch)
    expected = {
        "non_private": {k: 0.0 for k in KERNEL_INFO},
        "mixed_ghost": {"ghost_norm_sq": float(sum(shapes["ghost_norm_sq"].values())),
                        "book_weighted_grad": 0.0, "psg_contract": 0.0},
        "bk_mixed": {"ghost_norm_sq": float(sum(shapes["book_weighted_grad"].values())),
                     "book_weighted_grad": float(sum(shapes["book_weighted_grad"].values())),
                     "psg_contract": float(sum(shapes["psg_contract"].values()))},
    }
    print(f"VGG-19 taps at batch {BATCH}: expected kernel launches per step {expected}")
    kernels = phase_kernels(shapes)
    slice_out = phase_slice(model, BATCH, STEPS, expected)
    compare = phase_compare(model, params, batch)
    summary = summary_line(kernels, slice_out)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build": build, "batch": BATCH, "steps": STEPS,
        "kernels": kernels, "slice": slice_out, "compare": compare, "summary": summary,
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
