"""Platform helpers: the Hopper check and integer helpers.

Counterpart of nnop_tpu/utils/platform.py. The TPU stack's knobs (VMEM
budget, interpret mode, the XLA-vs-Pallas norm switch) have no meaning
here: an op picks its plain version only for a CPU tensor, and a CUDA
tensor always goes to the kernel.
"""

from __future__ import annotations

import torch


def require_hopper(device: int = 0) -> str:
    """Raise unless CUDA is present and `device` is compute capability 9.0
    (the `sm_90a` target the kernels are built for). Returns its name."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the kernels need an H100")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"device {device} ({torch.cuda.get_device_name(device)}) has "
            f"compute capability {cap}; the kernels are built for (9, 0)"
        )
    return torch.cuda.get_device_name(device)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def check_cuda_operand(name: str, t: torch.Tensor, dtypes, device=None):
    """Validate a tensor handed to a kernel: on CUDA, of an accepted dtype,
    contiguous, 16-byte aligned, and on `device` when given."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
