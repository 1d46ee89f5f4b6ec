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


def aligned16(name: str, **tensors) -> None:
    """Raise unless each tensor starts on a 16-byte boundary (the kernels'
    16-byte vector and cp.async copies; a contiguous tensor's rows then
    stay aligned wherever its last dimension is a multiple of 16 bytes)."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary")


def data_ptr(t) -> int | None:
    """A tensor's address for a ctypes pointer argument; None (NULL) for
    an absent tensor."""
    return None if t is None else t.data_ptr()


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


def row_offsets(name: str, value, b: int, device, what: str):
    """Per-row offsets as the kernels read them: an int32 [b] tensor on
    ``device``. A host int is broadcast to every row; a tensor of shape
    [] or [b] (any integer dtype) is converted."""
    if isinstance(value, torch.Tensor):
        if value.dtype.is_floating_point or value.dtype == torch.bool:
            raise TypeError(f"{name}: {what} must be an integer tensor, got "
                            f"{value.dtype}")
        if value.dim() > 1 or (value.dim() == 1 and value.shape[0] != b):
            raise ValueError(f"{name}: {what} must be a host int or a "
                             f"tensor of shape [] or [{b}], got "
                             f"{tuple(value.shape)}")
        value = value.to(device=device, dtype=torch.int32)
        return value.expand(b).contiguous()
    return torch.full((b,), int(value), dtype=torch.int32, device=device)


def plain_offsets(value, b: int, device):
    """Per-row offsets [b] (int64) for a plain version: a host int (filled
    on the device, no copy) or a tensor of shape [] or [b]."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.long).reshape(-1).expand(b)
    return torch.full((b,), int(value), dtype=torch.long, device=device)
