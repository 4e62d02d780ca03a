"""Build the port's CUDA kernels into one shared library and load it.

The sources under ``repro_torch/csrc/`` have a plain C interface, so they
are compiled by ``nvcc`` alone (no PyTorch headers): one ``nvcc -c`` per
source, all started together, then one link into a single ``.so`` that
``ctypes`` loads.  That takes seconds, against minutes for an extension
that includes PyTorch's headers.

The build happens at first use, from the checkout's own sources, into
``build/kernels/`` at the repository root (listed in ``.gitignore``).  The
library's name carries a digest of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs
at import time: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ghost_norm.cu", "embedding_norm.cu", "book_weighted_grad.cu", "psg_contract.cu",
           "flash_attention.cu", "errors.cu")
HEADERS = ("common.cuh", "hopper.cuh", "mma.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # a, g, out, partial, n, t, d, p, a_dtype, g_dtype, tile, stream
    "ghost_norm_sq_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, g, out, partial, n, h, w, c, kh, kw, sh, sw, pad top, bottom, left,
    # right, p, x_dtype, g_dtype, tile, stream
    "conv_ghost_norm_sq_launch": (_P, _P, _P, _P) + (_I,) * 16 + (_P,),
    # ids, g, out, order, units, sort workspace, n, t, p, id_dtype, g_dtype,
    # slices, blocks, stream
    "embedding_ghost_norm_sq_launch": (_P,) * 6 + (_I,) * 7 + (_P,),
    "embedding_sort_capacity": (),
    "embedding_segment_blocks_per_sm": (_I,),
    # a, g, w, out, partial, m, r, d, p, splits, rows_per_split, a_dtype, g_dtype, stream
    "book_weighted_grad_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # segment table (5 int64 each: psg, out, f, dtype, c row), segments, n, stream
    "psg_contract_grouped_launch": (_P, _I, _I, _P),
    # q, k, v, out, b, sq, skv, heads, kv_heads, hd, causal, window, q_offset,
    # scale, dtype, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output, ptxas register/spill report included


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source on a machine with the CUDA toolkit"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build(force: bool = False) -> BuildInfo:
    """Compile and link the kernels unless an up-to-date library exists."""
    lib = library_path()
    if lib.exists() and not force:
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tag = f"{_digest()}_{os.getpid()}"
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, _, proc in jobs:  # wait for every compiler, failed or not
        out, _ = proc.communicate()
        logs.append(f"== nvcc {src} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"librepro_torch_{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    logs.append(f"== nvcc -shared (exit {link.returncode})\n{link.stdout}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + "\n".join(logs))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    log = "\n".join(logs)
    lib.with_suffix(".log").write_text(log)
    return BuildInfo(lib, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        text = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {code} ({text})")
