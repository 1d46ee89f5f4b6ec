"""Argument checks shared by the kernel wrappers."""

import ctypes

import torch

# dtype codes of the C interfaces in csrc/
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

ptr = ctypes.c_void_p


def on_cuda(name: str, *tensors) -> bool:
    """False when every tensor lies on the CPU (the wrapper takes the
    plain version), True when all lie on one CUDA device (it launches the
    kernel). Anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors must all lie on the CPU or all "
                         f"on one CUDA device, got "
                         f"{sorted(str(d) for d in devices)}")
    return True


def dtype_code(name: str, t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: {what} must be float32 or bfloat16, got "
                        f"{t.dtype}")
    return code


def contiguous(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def status(name: str, rc: int) -> None:
    """Raise unless the C function reported a clean launch."""
    if rc == -1:
        raise ValueError(f"{name}: the kernel has no instance for these "
                         f"arguments")
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
