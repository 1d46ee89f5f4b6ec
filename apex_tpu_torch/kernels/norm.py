"""LayerNorm and RMSNorm forward and backward-dx: the CUDA kernels
(csrc/layer_norm.cu, csrc/rms_norm.cu) and their plain PyTorch versions.

Counterparts of ``apex_tpu/kernels/norm.py`` ``ln_fwd``, ``ln_bwd_dx``,
``rms_fwd`` and ``rms_bwd_dx``. The public entry points, with their
autograd, stay in :mod:`apex_tpu_torch.ops.layer_norm`.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

LAYER_NORM = registry.register("layer_norm")
LN_BWD = registry.register("ln_bwd")
RMS_NORM = registry.register("rms_norm")
RMS_BWD = registry.register("rms_bwd")
# #4's and #5's launch (csrc/layer_norm.cu `warp_ln_fwd`,
# `warp_ln_bwd_dx`): rows of at most REG_MAX_H elements live in the
# registers of one warp, ROW_WARPS rows a block; longer rows take one
# block of 256 threads a row. Path codes of apex_layer_norm_fwd and
# apex_layer_norm_bwd_dx:
LN_BWD_REG_MAX_H = 1024
LN_BWD_ROW_WARPS = 4
LN_BWD_BLOCK, LN_BWD_SCALAR, LN_BWD_VECTOR = 0, 1, 2
# #7's launch (csrc/rms_norm.cu `warp_rms_bwd_dx`): rows of at most
# RMS_BWD_REG_MAX_H elements live in registers, spread over the fewest of
# 1, 2, 4 or 8 warps (RMS_BWD_MAX_WARPS) that leave a lane at most
# RMS_BWD_LANE_MAX elements of each operand; longer rows take one block of
# 256 threads a row. Path codes of apex_rms_norm_bwd_dx as #5's.
RMS_BWD_REG_MAX_H = 2048
RMS_BWD_LANE_MAX = 32
RMS_BWD_MAX_WARPS = 8


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
        [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, i, p])


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
    path = ln_plan(h, x2d.element_size(), y.element_size(),
                   x2d.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0).path
    with torch.cuda.device(x2d.device):
        rc = _ln_kernel()(x2d.data_ptr(), _ptr(weight), _ptr(bias),
                          y.data_ptr(), n, h, float(eps), in_code, out_code,
                          path, _checks.stream(x2d))
    _checks.status("ln_fwd", rc)
    registry.count(LAYER_NORM, flops=8.0 * n * h,
                   bytes=registry.nbytes(x2d, weight, bias, y))
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


class LnPlan(NamedTuple):
    """How #4 or #5 launches for rows of ``h`` elements. ``path``:
    LN_BWD_BLOCK, LN_BWD_SCALAR or LN_BWD_VECTOR; ``vec`` elements an
    access; ``iters`` chunks of ``vec`` a lane holds (register paths; 0 on
    the block path)."""
    path: int
    vec: int
    iters: int


def ln_plan(h: int, a_itemsize: int, b_itemsize: int,
            aligned: bool) -> LnPlan:
    """The launch of #4 (x and y) or #5 (dy and x) for rows of ``h``
    elements of two operands of the given itemsizes, from shapes and
    alignment alone: rows of at most LN_BWD_REG_MAX_H elements live in
    one warp's registers, with 16-byte accesses of the narrower type (8
    elements when either is bf16, 4 when both are fp32) when h is a
    multiple of that vector and ``aligned`` (the row operands and the
    output start on 16-byte boundaries: the rows are contiguous, so each
    row then does too), else one element an access; longer rows take one
    block a row. A lane holds ``iters`` chunks, the chunks a row needs
    over 32 lanes rounded up to a power of two (the kernels' template
    buckets). The weight and bias do not enter: the kernels read each 16
    bytes at a time where it starts on that boundary, else element by
    element."""
    if h > LN_BWD_REG_MAX_H:
        return LnPlan(LN_BWD_BLOCK, 1, 0)
    vec = 16 // min(a_itemsize, b_itemsize)
    if not (aligned and h % vec == 0):
        vec = 1
    chunks = -(-h // (32 * vec))
    return LnPlan(LN_BWD_VECTOR if vec > 1 else LN_BWD_SCALAR, vec,
                  1 << max(0, chunks - 1).bit_length())


@functools.lru_cache(maxsize=1)
def _ln_bwd_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "layer_norm", "apex_layer_norm_bwd_dx",
        [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, i, p])


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (dy2d, x2d, dx))
    path = ln_plan(h, dy2d.element_size(), x2d.element_size(), aligned).path
    with torch.cuda.device(x2d.device):
        rc = _ln_bwd_kernel()(dy2d.data_ptr(), x2d.data_ptr(), _ptr(weight),
                              dx.data_ptr(), n, h, float(eps), dy_code,
                              x_code, path, _checks.stream(x2d))
    _checks.status("ln_bwd_dx", rc)
    registry.count(LN_BWD, flops=10.0 * n * h,
                   bytes=registry.nbytes(dy2d, x2d, weight, dx))
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
    registry.count(RMS_NORM, flops=5.0 * n * h,
                   bytes=registry.nbytes(x2d, weight, y))
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


class RmsBwdPlan(NamedTuple):
    """How #7 launches for rows of ``h`` elements. ``path``:
    LN_BWD_BLOCK, LN_BWD_SCALAR or LN_BWD_VECTOR (#5's codes); ``vec``
    elements an access; ``iters`` chunks of ``vec`` a lane holds and
    ``warps`` warps a row (register paths; 0 on the block path)."""
    path: int
    vec: int
    iters: int
    warps: int


def rms_bwd_plan(h: int, dy_itemsize: int, x_itemsize: int,
                 aligned: bool) -> RmsBwdPlan:
    """#7's launch for rows of ``h`` elements, dy and x of the given
    itemsizes, from shapes and alignment alone: rows of at most
    RMS_BWD_REG_MAX_H elements live in registers, with 16-byte accesses
    of the narrower type (8 elements when either is bf16, 4 when both are
    fp32) when h is a multiple of that vector and ``aligned`` (dy, x and dx
    start on 16-byte boundaries), else one element an access, spread over
    the fewest warps (a power of two, at most RMS_BWD_MAX_WARPS) that
    leave a lane at most RMS_BWD_LANE_MAX elements (at h 2048 two warps,
    the fastest of 2, 4 and 8 at [2048, 2048] bf16 rows on an H100:
    PERF.md section 6); longer rows take one block a row. A lane holds
    ``iters`` chunks, the chunks a row needs over its lanes rounded up to
    a power of two (the kernel's template buckets). The weight does not
    enter: the kernel reads it 16 bytes at a time where it starts on that
    boundary, else element by element."""
    if h > RMS_BWD_REG_MAX_H:
        return RmsBwdPlan(LN_BWD_BLOCK, 1, 0, 0)
    vec = 16 // min(dy_itemsize, x_itemsize)
    if not (aligned and h % vec == 0):
        vec = 1
    chunks = -(-h // vec)

    def iters(warps):
        return 1 << max(0, -(-chunks // (32 * warps)) - 1).bit_length()

    warps = 1
    while warps < RMS_BWD_MAX_WARPS and iters(warps) * vec > RMS_BWD_LANE_MAX:
        warps *= 2
    return RmsBwdPlan(LN_BWD_VECTOR if vec > 1 else LN_BWD_SCALAR, vec,
                      iters(warps), warps)


@functools.lru_cache(maxsize=1)
def _bwd_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "rms_norm", "apex_rms_norm_bwd_dx",
        [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, i, i, i, p])


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (dy2d, x2d, dx))
    plan = rms_bwd_plan(h, dy2d.element_size(), x2d.element_size(), aligned)
    with torch.cuda.device(x2d.device):
        rc = _bwd_kernel()(dy2d.data_ptr(), x2d.data_ptr(), weight.data_ptr(),
                           dx.data_ptr(), n, h, float(eps), dy_code, x_code,
                           plan.path, plan.warps, _checks.stream(x2d))
    _checks.status("rms_bwd_dx", rc)
    registry.count(RMS_BWD, flops=8.0 * n * h,
                   bytes=registry.nbytes(dy2d, x2d, weight, dx))
    return dx
