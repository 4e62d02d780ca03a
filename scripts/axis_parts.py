#!/usr/bin/env python3
"""Run chip_smoke.py's model-axis parts alone on one GPU, and the readings
that set their fp32 limits (``chip_smoke.AXIS_TOL``): build the kernels,
then each named part on two gloo ranks sharing the card
(``chip_smoke.spawn_ranks``), then each part's report.

    python3 scripts/axis_parts.py                 # the cnn and mamba parts
    python3 scripts/axis_parts.py conv_halves vgg19_forward vgg19_sound mamba_sound mamba

Parts: ``tp``, ``cnn``, ``mamba``, ``serve`` (``chip_smoke.AXIS_PARTS``:
their gates, then the kernels against their plain versions at the ranks'
shapes, with the summed ms, plain, library, bound and profiler device ms
of one step's calls, or of the serve part's prefills); and

- ``conv_halves`` (one process): each VGG-19 convolution at b128 fp32,
  cuDNN on and off, computed whole and as its two halves of output
  channels (a model rank's share; the input gradient the halves' sum):
  whether the halves give the whole conv's bits, each side's error against
  fp64, and the CUDA kernels each side ran;
- ``vgg19_sound``: VGG-19 b128 in np / mg / bk: the one-rank step in fp64
  (plain versions), in fp32 on cuDNN and on native convolutions, the
  sharded fp32 step and a bf16-compute sharded step (the control), each
  pair's errors as the dist gate reads them, and how many ReLU signs and
  max-pool picks of the forward each pair differs in, per block and per
  sample;
- ``vgg19_forward``: VGG-19's non_private forward, sharded and on one
  rank: per convolution, whether its input, weight and output (rank 0's
  half) hold the same bits, with the weights' alignment and the strides;
- ``mamba_sound``: Jamba's Mamba layer (chip_smoke's mamba part) in np /
  mg / bk: the fp32 one-rank step against fp64 at 2 x MAMBA_F64_SEQ (the
  floor), and a bf16-compute sharded step against the fp32 one-rank step
  at 2 x MAMBA_SEQ (the control), rank 0's slices.

Prints the card's name and power limit last; exits non-zero when a gated
part fails.
"""
from __future__ import annotations

import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402

VGG_RELUS, VGG_POOLS = 16, 5
# VGG-19's blocks by ReLU: (first, end) of each resolution's convs
VGG_BLOCKS = {"32x32": (0, 2), "16x16": (2, 4), "8x8": (4, 8), "4x4": (8, 12), "2x2": (12, 16)}


class _Flips:
    """Records the sign of every ReLU input and every max-pool pick of the
    first VGG-19 forward run under it (the forward only: the first
    VGG_RELUS ReLUs and VGG_POOLS pools)."""

    def __enter__(self):
        import torch.nn.functional as F

        from repro_torch.models import cnn

        self.signs, self.picks = [], []
        self.relu, self.pool = F.relu, cnn.max_pool2d

        def relu(x, *a, **kw):
            if len(self.signs) < VGG_RELUS:
                self.signs.append(x.detach() > 0)
            return self.relu(x, *a, **kw)

        def pool(x, window: int = 2, stride: int = 2):
            if len(self.picks) < VGG_POOLS:
                _, idx = F.max_pool2d(x.detach().permute(0, 3, 1, 2), window, stride,
                                      return_indices=True)
                self.picks.append(idx)
            return self.pool(x, window, stride)

        F.relu, cnn.max_pool2d = relu, pool
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        from repro_torch.models import cnn

        F.relu, cnn.max_pool2d = self.relu, self.pool

    def against(self, other: "_Flips") -> dict:
        """ReLU signs and pool picks that differ: per block, per pool, and
        per sample (a list of counts)."""
        import torch

        signs = [(a != b) for a, b in zip(self.signs, other.signs)]
        picks = [(a != b) for a, b in zip(self.picks, other.picks)]
        per_sample = sum(d.flatten(1).sum(1) for d in signs + picks)
        return {"relu": {blk: int(sum(signs[i].sum() for i in range(lo, hi)))
                         for blk, (lo, hi) in VGG_BLOCKS.items()},
                "pool": [int(d.sum()) for d in picks],
                "per_sample": per_sample.to(torch.int64).cpu().tolist()}


def _pair(got: dict, want: dict, mode: str) -> dict:
    err, worst = cs._axis_errs(got, want, mode)
    return {"err": err, "worst": worst}


def _vgg19_sound(rank: int, n: int) -> dict:
    """VGG-19's sound fp32 runs, their fp64 reference and the bf16 control
    (module docstring), each mode's pairs and flips on rank 0."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(cs.TP_MESH, "cuda")
    t0 = time.perf_counter()
    parts = {"fp64": dict(cs._vision_part("vgg19", cs.CNN_VGG_BATCH, "float64"), plain=True),
             "fp32": cs._vision_part("vgg19", cs.CNN_VGG_BATCH, "float32"),
             "bf16": cs._vision_part("vgg19", cs.CNN_VGG_BATCH, "bfloat16")}
    native = dict(enabled=False, benchmark=False, deterministic=False, allow_tf32=False)
    out = {}
    for mode in cs.TP_MODES:
        model = parts["fp32"]["build"]()
        shardings, layout = cs._axis_layout(parts["fp32"], model, mesh)
        runs, flips = {}, {}
        for name, part, flags in (("one-rank fp64", parts["fp64"], None),
                                  ("one-rank fp32", parts["fp32"], None),
                                  ("one-rank fp32 native", parts["fp32"], native)):
            with (torch.backends.cudnn.flags(**flags) if flags else cs.contextlib.nullcontext(),
                  _Flips() as flips[name]):
                runs[name] = cs._axis_ref(part, mode, rank, n, layout.local, "together")
        with _Flips() as flips["sharded fp32"]:
            runs["sharded fp32"], _ = cs._axis_sharded(parts["fp32"], mode, model, mesh,
                                                       shardings, layout)
        del model
        model = parts["bf16"]["build"]()
        shardings, layout16 = cs._axis_layout(parts["bf16"], model, mesh)
        runs["sharded bf16"], _ = cs._axis_sharded(parts["bf16"], mode, model, mesh,
                                                   shardings, layout16)
        del model
        pairs = {"sharded fp32 vs one-rank fp32 (the gate)": ("sharded fp32", "one-rank fp32"),
                 "one-rank fp32 vs fp64 (the floor)": ("one-rank fp32", "one-rank fp64"),
                 "one-rank fp32 native vs fp64": ("one-rank fp32 native", "one-rank fp64"),
                 "one-rank fp32 native vs cuDNN": ("one-rank fp32 native", "one-rank fp32"),
                 "sharded fp32 vs fp64": ("sharded fp32", "one-rank fp64"),
                 "sharded bf16 vs one-rank fp32 (the control)": ("sharded bf16",
                                                                 "one-rank fp32")}
        row = {}
        for label, (a, b) in pairs.items():
            row[label] = _pair(runs[a], runs[b], mode)
            if a in flips and b in flips:
                row[label]["flips"] = flips[a].against(flips[b])
            if a in flips and b in flips and mode != "non_private":  # per sample
                d = ((runs[a]["norms"].double() - runs[b]["norms"].double()).abs()
                     / runs[b]["norms"].abs().max()).cpu()
                row[label]["norm_err_per_sample"] = d.tolist()
        out[mode] = row
        del runs, flips
        cs._free()
    return {"modes": out, "seconds": time.perf_counter() - t0}


class _Convs:
    """Records the input, weight and output of the first VGG_RELUS
    ``F.conv2d`` calls run under it, with the weight's address modulo 256
    and each tensor's strides."""

    def __enter__(self):
        import torch.nn.functional as F

        self.calls, self.conv2d = [], F.conv2d

        def conv2d(x, w, *a, **kw):
            out = self.conv2d(x, w, *a, **kw)
            if len(self.calls) < VGG_RELUS:
                self.calls.append({"x": x.detach().clone(), "w": w.detach().clone(),
                                   "out": out.detach().clone(), "w_align": w.data_ptr() % 256,
                                   "x_align": x.data_ptr() % 256, "strides": (
                                       x.stride(), w.stride(), out.stride())})
            return out

        F.conv2d = conv2d
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.conv2d = self.conv2d


def _vgg19_forward(rank: int, n: int) -> dict:
    """Where VGG-19's sharded fp32 forward first rounds apart from the
    one-rank forward (non_private, rank 0): per convolution, whether its
    input, its weight (rank 0's half) and its output (rank 0's half of the
    one-rank output) hold the same bits, with the weights' alignment and
    the strides on each side."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(cs.TP_MESH, "cuda")
    part = cs._vision_part("vgg19", cs.CNN_VGG_BATCH, "float32")
    model = part["build"]()
    shardings, layout = cs._axis_layout(part, model, mesh)
    with _Convs() as one:
        cs._axis_ref(part, "non_private", rank, n, None, "rank0")
    with _Convs() as sharded:
        cs._axis_sharded(part, "non_private", model, mesh, shardings, layout)
    rows = []
    if rank == 0:
        for i, (a, b) in enumerate(zip(sharded.calls, one.calls)):
            h = a["out"].shape[1]
            row = {"conv": i}
            for k, want in (("x", b["x"]), ("w", b["w"][:h]), ("out", b["out"][:, :h])):
                got = a[k]
                row[k] = ("equal" if got.shape == want.shape and bool((got == want).all())
                          else f"{float((got - want).abs().max()) / float(want.abs().max()):.2e}")
            row["align"] = {"sharded w": a["w_align"], "one-rank w": b["w_align"],
                            "sharded x": a["x_align"], "one-rank x": b["x_align"]}
            row["strides"] = {"sharded": a["strides"], "one-rank": b["strides"]}
            rows.append(row)
    return {"convs": rows}


def _mamba_sound(rank: int, n: int) -> dict:
    """Jamba's floor and bf16 control (module docstring), rank 0's slices
    on the host."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(cs.TP_MESH, "cuda")
    t0 = time.perf_counter()
    cfg = {d: cs._mamba_cfg(d) for d in ("float64", "float32", "bfloat16")}
    out = {}
    for mode in cs.TP_MODES:
        short = cs._lm_part(cfg["float32"], cs.MAMBA_BATCH, cs.MAMBA_F64_SEQ)
        model = short["build"]()
        _, layout = cs._axis_layout(short, model, mesh)
        del model

        def keep(k, v):
            return layout.local(k, v).cpu()

        r64 = cs._axis_ref(dict(cs._lm_part(cfg["float64"], cs.MAMBA_BATCH, cs.MAMBA_F64_SEQ),
                                plain=True), mode, rank, n, keep, "rank0")
        r32 = cs._axis_ref(short, mode, rank, n, keep, "rank0")
        row = {"one-rank fp32 vs fp64 (the floor), 2 x MAMBA_F64_SEQ":
               _pair(r32, r64, mode) if rank == 0 else None}
        del r64, r32
        ref = cs._axis_ref(cs._lm_part(cfg["float32"], cs.MAMBA_BATCH, cs.MAMBA_SEQ), mode,
                           rank, n, keep, "rank0")
        part = cs._lm_part(cfg["bfloat16"], cs.MAMBA_BATCH, cs.MAMBA_SEQ)
        model = part["build"]()
        shardings, layout16 = cs._axis_layout(part, model, mesh)
        got, _ = cs._axis_sharded(part, mode, model, mesh, shardings, layout16)
        if rank == 0:
            row["sharded bf16 vs one-rank fp32 (the control), 2 x MAMBA_SEQ"] = _pair(
                got, ref, mode)
        del model, got, ref
        cs._free()
        out[mode] = row
    return {"modes": out, "seconds": time.perf_counter() - t0}


SOUND = {"vgg19_sound": _vgg19_sound, "vgg19_forward": _vgg19_forward,
         "mamba_sound": _mamba_sound}


def _parts(rank: int, n: int, names: list) -> dict:
    """The named ranked parts on this rank."""
    res = {"rank": rank}
    for name in names:
        cs._free()
        res[name] = {**cs.AXIS_PARTS, **SOUND}[name](rank, n)
    return res


def conv_halves() -> None:
    """Each VGG-19 convolution whole and in halves (module docstring)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.cnn import VGG_PLANS

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes, ch, size = [], 3, 32
    for item in VGG_PLANS["vgg19"]:
        if item == "M":
            size //= 2
            continue
        shapes.append((ch, item, size))
        ch = item

    def whole(x, w, gy):
        """Output, input gradient, weight gradient of the whole conv."""
        return (F.conv2d(x, w, padding=1),
                torch.nn.grad.conv2d_input(x.shape, w, gy, padding=1),
                torch.nn.grad.conv2d_weight(x, w.shape, gy, padding=1))

    def halves(x, w, gy):
        """The same from the two halves of the output channels."""
        h = w.shape[0] // 2
        lo, hi = (slice(None, h), slice(h, None))
        return (torch.cat([F.conv2d(x, w[s], padding=1) for s in (lo, hi)], 1),
                sum(torch.nn.grad.conv2d_input(x.shape, w[s], gy[:, s], padding=1)
                    for s in (lo, hi)),
                torch.cat([torch.nn.grad.conv2d_weight(x, w[s].shape, gy[:, s], padding=1)
                           for s in (lo, hi)], 0))

    def kernels(fn, *args) -> list:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        return sorted({e.name[:60] for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA})

    for i, (cin, cout, size) in enumerate(shapes):
        x = torch.randn(cs.CNN_VGG_BATCH, size, size, cin, device="cuda",
                        generator=gen).permute(0, 3, 1, 2)  # the port's NHWC view
        w = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (9 * cin) ** 0.5
        gy = torch.randn(cs.CNN_VGG_BATCH, size, size, cout, device="cuda",
                         generator=gen).permute(0, 3, 1, 2)
        exact = whole(x.double(), w.double(), gy.double())
        for conv in ("cudnn", "native"):
            with torch.backends.cudnn.flags(enabled=conv == "cudnn", benchmark=False,
                                            deterministic=False, allow_tf32=False):
                got = whole(x, w, gy), halves(x, w, gy)
                names = {"whole": kernels(whole, x, w, gy), "halves": kernels(halves, x, w, gy)}
            line = []
            for what, a, b, e in zip(("out", "dgrad", "wgrad"), *got, exact):
                scale = float(e.abs().max())
                line.append(f"{what} bits {'equal' if torch.equal(a, b) else 'differ'}, "
                            f"halves-whole {float((a - b).abs().max()) / scale:.2e}, whole-fp64 "
                            f"{float((a.double() - e).abs().max()) / scale:.2e}, halves-fp64 "
                            f"{float((b.double() - e).abs().max()) / scale:.2e}")
            print(f"conv_halves conv#{i} {cin}->{cout} at {size}x{size} b{cs.CNN_VGG_BATCH} "
                  f"{conv}: " + "; ".join(line) + f"; kernels whole {names['whole']}, halves "
                  f"{names['halves']}", flush=True)


def _print_sound(name: str, res: dict) -> None:
    for row in res.get("convs", ()):
        print(f"{name} {row}", flush=True)
    if "modes" not in res:
        return
    for mode, row in res["modes"].items():
        for label, pair in row.items():
            if pair is None:
                continue
            errs = ", ".join(f"{k} {v:.3g}" for k, v in pair["err"].items())
            print(f"{name} {mode} {label}: {errs}; worst {pair['worst']}", flush=True)
            if "flips" in pair:
                fl = pair["flips"]
                print(f"{name} {mode} {label}: ReLU signs differing by block {fl['relu']}, "
                      f"max-pool picks by pool {fl['pool']}", flush=True)
            if "norm_err_per_sample" in pair:
                d, f = pair["norm_err_per_sample"], pair["flips"]["per_sample"]
                top = sorted(range(len(d)), key=lambda i: -d[i])[:5]
                calm = [d[i] for i in range(len(d)) if f[i] == 0]
                print(f"{name} {mode} {label}: samples by norm error (sample, error, flips) "
                      f"{[(i, f'{d[i]:.2e}', f[i]) for i in top]}; samples with a flip "
                      f"{sum(1 for c in f if c)}, the largest error among the rest "
                      f"{max(calm, default=0.0):.2e}", flush=True)
    print(f"{name}: {res['seconds']:.1f} s in the ranks", flush=True)


def _print_part(name: str, results: dict) -> None:
    rep = (cs._serve_report if name == "serve" else cs._axis_report)(results, name)
    rows: dict = {}
    for kernel, cases in rep["kernel_cases"].items():
        for c in cases:
            rows.setdefault((kernel, c["path"]), []).append(c)
    for (kernel, path), cases in sorted(rows.items()):
        tot = {k: sum(c[k] * c["calls_per_step"] for c in cases)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        dev = [c.get("device_ms") for c in cases]
        dev_ms = (None if any(d is None for d in dev)
                  else sum(d * c["calls_per_step"] for d, c in zip(dev, cases)))
        print(f"{name} kernel {kernel} {path}: {len(cases)} shapes; "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f"; device {'not measured' if dev_ms is None else f'{dev_ms:.4f}'}")
    print(f"{name}: {results[0][name]['seconds']:.1f} s in the ranks; launches "
          f"{rep['launches_by_model']}", flush=True)


def main() -> int:
    import torch

    names = sys.argv[1:] or ["cnn", "mamba"]
    known = {"conv_halves", *cs.AXIS_PARTS, *SOUND}
    if set(names) - known:
        print(f"axis_parts: unknown parts {sorted(set(names) - known)}; known {sorted(known)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("axis_parts: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    if "conv_halves" in names:
        conv_halves()
    ranked = [name for name in names if name != "conv_halves"]
    failed = []
    if ranked:
        results = cs.spawn_ranks(_parts, ranked)
        for name in ranked:
            if name in SOUND:
                _print_sound(name, results[0][name])
                continue
            try:
                _print_part(name, results)
            except cs.SmokeFailure:
                traceback.print_exc()
                failed.append(name)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
