"""RMSNorm forward: the CUDA kernel (csrc/rms_norm.cu) and its plain
PyTorch version.

Counterpart of ``apex_tpu/kernels/norm.py`` ``rms_fwd``. The public
entry point stays in :mod:`apex_tpu_torch.ops.layer_norm`. The LayerNorm
kernels and the backward-dx kernels of that module come with training.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

RMS_NORM = registry.register("rms_norm")


def rms_fwd_plain(x2d, weight, eps, out_dtype=None):
    """x2d [n, h] -> x * rsqrt(mean(x*x) + eps) * w in fp32, rounded to
    x2d's dtype and then to ``out_dtype`` (default: x2d's dtype), as
    ``apex_tpu.ops.layer_norm.rms_norm``."""
    x = x2d.float()
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(ms + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x2d.dtype).to(out_dtype or x2d.dtype)


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "rms_norm", "apex_rms_norm_fwd",
        [p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, p])


def rms_fwd(x2d, weight, eps, out_dtype=None):
    """RMSNorm of each row of x2d [n, h] (fp32 or bf16) with an fp32
    weight [h] (or None), output in ``out_dtype`` (fp32 or bf16; default
    x2d's dtype). A CPU tensor takes :func:`rms_fwd_plain`; a CUDA
    tensor launches the kernel or raises."""
    out_dtype = out_dtype or x2d.dtype
    tensors = (x2d,) if weight is None else (x2d, weight)
    if not _checks.on_cuda("rms_fwd", *tensors):
        return rms_fwd_plain(x2d, weight, eps, out_dtype)
    if x2d.dim() != 2:
        raise ValueError(f"rms_fwd: x2d must be [n, h], got {tuple(x2d.shape)}")
    n, h = x2d.shape
    if weight is None:
        weight = torch.ones(h, dtype=torch.float32, device=x2d.device)
    if weight.dtype != torch.float32 or tuple(weight.shape) != (h,):
        raise ValueError(f"rms_fwd: weight must be float32 [{h}], got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    _checks.contiguous("rms_fwd", x2d=x2d, weight=weight)
    in_code = _checks.dtype_code("rms_fwd", x2d, "x2d")
    y = torch.empty((n, h), dtype=out_dtype, device=x2d.device)
    out_code = _checks.dtype_code("rms_fwd", y, "out_dtype")
    with torch.cuda.device(x2d.device):
        rc = _kernel()(x2d.data_ptr(), weight.data_ptr(), y.data_ptr(), n, h,
                       float(eps), in_code, out_code, _checks.stream(x2d))
    _checks.status("rms_fwd", rc)
    registry.count(RMS_NORM)
    return y
