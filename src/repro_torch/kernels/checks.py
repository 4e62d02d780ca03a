"""Argument checks the CUDA wrappers run before handing pointers to C."""
from __future__ import annotations

import torch

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2, torch.int64: 3}
FLOATS = (torch.float32, torch.bfloat16)
IDS = (torch.int32, torch.int64)
INT32_MAX = 2**31 - 1

# The card an abstract evaluation (a dry run over fake tensors) lays the
# kernels' grids and buffers out for: an H100 SXM5 80GB, whose 132 SMs
# (NVIDIA's H100 architecture whitepaper, the SXM5 part) are what
# torch.cuda.get_device_properties reads there; the embedding norm's
# occupancy and shared-memory sort capacity are the built library's readings
# on that card (chip_smoke.py's dryrun phase holds them to the live values).
TARGET_SM_COUNT = 132
TARGET_EMBED_BLOCKS_PER_SM = {torch.float32: 5, torch.bfloat16: 4}
TARGET_EMBED_SORT_CAPACITY = 9900


def operand(name: str, x: torch.Tensor, ndim: int, dtypes=FLOATS) -> None:
    """A CUDA, contiguous tensor of rank ``ndim`` and one of ``dtypes``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    if x.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} dtype {x.dtype} not in {[str(d) for d in dtypes]}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(**tensors: torch.Tensor) -> None:
    devices = {str(t.device) for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")


def fits_int32(what: str, value: int) -> None:
    if value > INT32_MAX:
        raise ValueError(f"{what} = {value} exceeds the kernel's 32-bit index range")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
