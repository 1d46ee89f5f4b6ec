"""LayerNorm and RMSNorm forward and backward-dx: the CUDA kernels
(csrc/layer_norm.cu, csrc/rms_norm.cu) and their plain PyTorch versions.

Counterparts of ``apex_tpu/kernels/norm.py`` ``ln_fwd``, ``ln_bwd_dx``,
``rms_fwd`` and ``rms_bwd_dx``. The public entry points, with their
autograd, stay in :mod:`apex_tpu_torch.ops.layer_norm`.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

LAYER_NORM = registry.register("layer_norm")
LN_BWD = registry.register("ln_bwd")
RMS_NORM = registry.register("rms_norm")
RMS_BWD = registry.register("rms_bwd")


def _vector(name, what, t, h):
    if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (h,)):
        raise ValueError(f"{name}: {what} must be float32 [{h}], got "
                         f"{t.dtype} {tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _given(**tensors):
    """The named tensors that are not None."""
    return {k: t for k, t in tensors.items() if t is not None}


def _ln_stats(x):
    """fp32 (mean, var) of each row in the TPU kernel's two-pass order."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mean
    return mean, torch.mean(xc * xc, dim=-1, keepdim=True)


def ln_fwd_plain(x2d, weight, bias, eps, out_dtype=None):
    """x2d [n, h] -> (x - mean) * rsqrt(var + eps) * w + b in fp32,
    rounded to x2d's dtype and then to ``out_dtype`` (default: x2d's
    dtype), as ``apex_tpu.ops.layer_norm.layer_norm``."""
    x = x2d.float()
    mean, var = _ln_stats(x)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype).to(out_dtype or x2d.dtype)


@functools.lru_cache(maxsize=1)
def _ln_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "layer_norm", "apex_layer_norm_fwd",
        [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, p])


def ln_fwd(x2d, weight, bias, eps, out_dtype=None):
    """LayerNorm of each row of x2d [n, h] (fp32 or bf16) with an fp32
    weight and bias [h] (either may be None), output in ``out_dtype``
    (fp32 or bf16; default x2d's dtype). A CPU tensor takes
    :func:`ln_fwd_plain`; a CUDA tensor launches the kernel or raises."""
    out_dtype = out_dtype or x2d.dtype
    tensors = _given(x2d=x2d, weight=weight, bias=bias)
    if not _checks.on_cuda("ln_fwd", *tensors.values()):
        return ln_fwd_plain(x2d, weight, bias, eps, out_dtype)
    if x2d.dim() != 2:
        raise ValueError(f"ln_fwd: x2d must be [n, h], got {tuple(x2d.shape)}")
    n, h = x2d.shape
    _vector("ln_fwd", "weight", weight, h)
    _vector("ln_fwd", "bias", bias, h)
    _checks.contiguous("ln_fwd", **tensors)
    in_code = _checks.dtype_code("ln_fwd", x2d, "x2d")
    y = torch.empty((n, h), dtype=out_dtype, device=x2d.device)
    out_code = _checks.dtype_code("ln_fwd", y, "out_dtype")
    with torch.cuda.device(x2d.device):
        rc = _ln_kernel()(x2d.data_ptr(), _ptr(weight), _ptr(bias),
                          y.data_ptr(), n, h, float(eps), in_code, out_code,
                          _checks.stream(x2d))
    _checks.status("ln_fwd", rc)
    registry.count(LAYER_NORM)
    return y


def ln_bwd_dx_plain(dy2d, x2d, weight, eps):
    """dx of LayerNorm for rows x2d [n, h] and their output gradient dy2d
    [n, h]: (w*dy - mean(w*dy) - xhat * mean(w*dy*xhat)) * rstd in fp32,
    the row statistics recomputed from x2d; returned in x2d's dtype, as
    ``apex_tpu.kernels.norm.ln_bwd_dx``."""
    dy = dy2d.float()
    x = x2d.float()
    mean, var = _ln_stats(x)
    rstd = torch.rsqrt(var + eps)
    xhat = (x - mean) * rstd
    wdy = dy * weight.float() if weight is not None else dy
    c1 = torch.mean(wdy, dim=-1, keepdim=True)
    c2 = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    return ((wdy - c1 - xhat * c2) * rstd).to(x2d.dtype)


@functools.lru_cache(maxsize=1)
def _ln_bwd_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "layer_norm", "apex_layer_norm_bwd_dx",
        [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, p])


def ln_bwd_dx(dy2d, x2d, weight, eps):
    """LayerNorm backward-dx of rows x2d [n, h] (fp32 or bf16) given dy2d
    [n, h] (fp32 or bf16) and the fp32 weight [h] (or None); dx in x2d's
    dtype. A CPU tensor takes :func:`ln_bwd_dx_plain`; a CUDA tensor
    launches the kernel or raises."""
    tensors = _given(dy2d=dy2d, x2d=x2d, weight=weight)
    if not _checks.on_cuda("ln_bwd_dx", *tensors.values()):
        return ln_bwd_dx_plain(dy2d, x2d, weight, eps)
    if x2d.dim() != 2 or dy2d.shape != x2d.shape:
        raise ValueError(f"ln_bwd_dx: x2d and dy2d must be one [n, h] shape, "
                         f"got {tuple(x2d.shape)} and {tuple(dy2d.shape)}")
    n, h = x2d.shape
    _vector("ln_bwd_dx", "weight", weight, h)
    _checks.contiguous("ln_bwd_dx", **tensors)
    dy_code = _checks.dtype_code("ln_bwd_dx", dy2d, "dy2d")
    x_code = _checks.dtype_code("ln_bwd_dx", x2d, "x2d")
    dx = torch.empty_like(x2d)
    if n == 0:
        return dx
    with torch.cuda.device(x2d.device):
        rc = _ln_bwd_kernel()(dy2d.data_ptr(), x2d.data_ptr(), _ptr(weight),
                              dx.data_ptr(), n, h, float(eps), dy_code,
                              x_code, _checks.stream(x2d))
    _checks.status("ln_bwd_dx", rc)
    registry.count(LN_BWD)
    return dx


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
    _vector("rms_fwd", "weight", weight, h)
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


def rms_bwd_dx_plain(dy2d, x2d, weight, eps):
    """dx of RMSNorm for rows x2d [n, h] and their output gradient dy2d
    [n, h]: (w*dy - xhat * mean(w*dy*xhat)) * rstd in fp32, the row
    statistics recomputed from x2d; returned in x2d's dtype, as
    ``apex_tpu.kernels.norm.rms_bwd_dx``."""
    dy = dy2d.float()
    x = x2d.float()
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    rstd = torch.rsqrt(ms + eps)
    xhat = x * rstd
    wdy = dy * weight.float() if weight is not None else dy
    c = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    return ((wdy - xhat * c) * rstd).to(x2d.dtype)


@functools.lru_cache(maxsize=1)
def _bwd_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "rms_norm", "apex_rms_norm_bwd_dx",
        [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, p])


def rms_bwd_dx(dy2d, x2d, weight, eps):
    """RMSNorm backward-dx of rows x2d [n, h] (fp32 or bf16) given dy2d
    [n, h] (fp32 or bf16) and the fp32 weight [h] (or None); dx in x2d's
    dtype. A CPU tensor takes :func:`rms_bwd_dx_plain`; a CUDA tensor
    launches the kernel or raises."""
    tensors = (dy2d, x2d) if weight is None else (dy2d, x2d, weight)
    if not _checks.on_cuda("rms_bwd_dx", *tensors):
        return rms_bwd_dx_plain(dy2d, x2d, weight, eps)
    if x2d.dim() != 2 or dy2d.shape != x2d.shape:
        raise ValueError(f"rms_bwd_dx: x2d and dy2d must be one [n, h] shape, "
                         f"got {tuple(x2d.shape)} and {tuple(dy2d.shape)}")
    n, h = x2d.shape
    if weight is None:
        weight = torch.ones(h, dtype=torch.float32, device=x2d.device)
    _vector("rms_bwd_dx", "weight", weight, h)
    _checks.contiguous("rms_bwd_dx", dy2d=dy2d, x2d=x2d, weight=weight)
    dy_code = _checks.dtype_code("rms_bwd_dx", dy2d, "dy2d")
    x_code = _checks.dtype_code("rms_bwd_dx", x2d, "x2d")
    dx = torch.empty_like(x2d)
    if n == 0:
        return dx
    with torch.cuda.device(x2d.device):
        rc = _bwd_kernel()(dy2d.data_ptr(), x2d.data_ptr(), weight.data_ptr(),
                           dx.data_ptr(), n, h, float(eps), dy_code, x_code,
                           _checks.stream(x2d))
    _checks.status("rms_bwd_dx", rc)
    registry.count(RMS_BWD)
    return dx
