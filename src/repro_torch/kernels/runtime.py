"""Device rules shared by the entry points and the kernel wrappers.

Entry points run on CUDA unless the caller names another device; with no
CUDA device they raise rather than fall back to the CPU. A kernel wrapper
launches its kernel for a CUDA tensor and runs its plain version only for a
tensor that lies on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is wanted and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on one CUDA device (launch the kernel),
    False when they all lie on the CPU (plain version); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def stream() -> int:
    """The current CUDA stream of the current device, as a pointer value."""
    return torch.cuda.current_stream().cuda_stream


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")
