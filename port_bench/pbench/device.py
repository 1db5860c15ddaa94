"""The card: refuse to run without one, and describe it in the result."""

from __future__ import annotations

import shutil
import subprocess


class NoCard(RuntimeError):
    pass


def require_cuda(chips: int) -> None:
    """Raise NoCard unless torch sees `chips` CUDA devices: the benchmark
    measures the card and never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, torch sees "
                     f"{torch.cuda.device_count()}")


def power_limit_w(index: int = 0):
    """The card's power limit in W as nvidia-smi reads it (None without it)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(index)], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def describe(device, memory_peak_bytes: int, count: int = 1) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(memory_peak_bytes), "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power_limit_w": None}
