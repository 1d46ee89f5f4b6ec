"""Scaled, scaled-masked and causal softmax forward and the softmax
backward: the CUDA kernels (csrc/softmax.cu) and their plain PyTorch
versions.

Counterparts of ``apex_tpu/kernels/softmax.py`` ``_scaled_fwd``,
``_masked_fwd``, ``_causal_fwd`` and ``_bwd_rows``. The autograd entry
points are in
:mod:`apex_tpu_torch.transformer.functional.fused_softmax`. Masks
follow the reference convention: non-zero (True) where masked out.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

MASK_VALUE = -10000.0
MAX_KEYS = 16384  # the forward stages a row of fp32 scores in shared memory
SCALED_SOFTMAX = registry.register("scaled_softmax")
MASKED_SOFTMAX = registry.register("masked_softmax")
CAUSAL_SOFTMAX = registry.register("causal_softmax")
SOFTMAX_BWD = registry.register("softmax_bwd")


def causal_softmax_fwd_plain(x, scale):
    """x [..., sq, sk] -> softmax over the last dim of x*scale with keys
    j > i + (sk - sq) masked: in fp32, masked scores set to -10000, the
    row max subtracted, exp, masked entries set to 0, normalised; the
    result in x's dtype, as ``apex_tpu``'s jnp oracle."""
    sq, sk = x.shape[-2:]
    live = torch.ones(sq, sk, dtype=torch.bool, device=x.device).tril(sk - sq)
    xf = torch.where(live, x.float() * scale, MASK_VALUE)
    xf = xf - torch.amax(xf, dim=-1, keepdim=True)
    e = torch.where(live, torch.exp(xf), 0.0)
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def scaled_softmax_fwd_plain(x, scale):
    """Softmax over the last dim of x*scale in fp32 (row max subtracted),
    in x's dtype, as ``apex_tpu``'s jnp oracle."""
    xf = x.float() * scale
    xf = xf - torch.amax(xf, dim=-1, keepdim=True)
    e = torch.exp(xf)
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def scaled_masked_softmax_fwd_plain(x, mask, scale):
    """As :func:`scaled_softmax_fwd_plain` with the keys where ``mask``
    (broadcast to x's shape) is non-zero set to -10000 before the max and
    to 0 after the exp; a row with every key masked is 0 / 0 = NaN, as in
    ``apex_tpu``'s oracle."""
    m = mask != 0
    xf = torch.where(m, MASK_VALUE, x.float() * scale)
    xf = xf - torch.amax(xf, dim=-1, keepdim=True)
    e = torch.where(m, 0.0, torch.exp(xf))
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def softmax_bwd_plain(y, dy, scale):
    """dx = scale * y * (dy - sum(dy * y)) over the last dim, in fp32,
    returned in y's dtype (``apex_tpu``'s ``_bwd_kernel``)."""
    yf = y.float()
    dyf = dy.float()
    t = torch.sum(dyf * yf, dim=-1, keepdim=True)
    return (scale * yf * (dyf - t)).to(y.dtype)


@functools.lru_cache(maxsize=1)
def _fwd_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "softmax", "apex_causal_softmax_fwd",
        [p, p, ctypes.c_longlong, i, i, ctypes.c_float, i, p])


@functools.lru_cache(maxsize=1)
def _masked_kernel():
    p, i, ll = _checks.ptr, ctypes.c_int, ctypes.c_longlong
    return _build.function(
        "softmax", "apex_masked_softmax_fwd",
        [p, p, p, ll, i, i, i, ll, ll, ll, ctypes.c_float, i, p])


@functools.lru_cache(maxsize=1)
def _bwd_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "softmax", "apex_softmax_bwd",
        [p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, p])


def _rows(name, t):
    rows = t.numel() // t.shape[-1]
    if rows >= 2 ** 31:
        raise ValueError(f"{name}: {rows} rows exceed one launch's grid")
    return rows


def causal_softmax_fwd(x, scale):
    """Causal softmax of x [B, sq, sk] (fp32 or bf16, sk <= 16384) scaled
    by ``scale``, in x's dtype. A CPU tensor takes
    :func:`causal_softmax_fwd_plain`; a CUDA tensor launches the kernel or
    raises."""
    if not _checks.on_cuda("causal_softmax_fwd", x):
        return causal_softmax_fwd_plain(x, scale)
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"causal_softmax_fwd: x must be a non-empty "
                         f"[B, sq, sk], got {tuple(x.shape)}")
    _, sq, sk = x.shape
    if sk > MAX_KEYS:
        raise ValueError(f"causal_softmax_fwd: sk ({sk}) exceeds {MAX_KEYS}")
    _checks.contiguous("causal_softmax_fwd", x=x)
    code = _checks.dtype_code("causal_softmax_fwd", x, "x")
    rows = _rows("causal_softmax_fwd", x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _fwd_kernel()(x.data_ptr(), y.data_ptr(), rows, sq, sk,
                           float(scale), code, _checks.stream(x))
    _checks.status("causal_softmax_fwd", rc)
    registry.count(CAUSAL_SOFTMAX)
    return y


def _check_rows(name, x):
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: x must be non-empty, got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] > MAX_KEYS:
        raise ValueError(f"{name}: sk ({x.shape[-1]}) exceeds {MAX_KEYS}")
    _checks.contiguous(name, x=x)
    return _checks.dtype_code(name, x, "x"), _rows(name, x)


def scaled_softmax_fwd(x, scale):
    """Softmax over the last dim (sk <= 16384) of x*scale, x of any shape,
    fp32 or bf16, in x's dtype. A CPU tensor takes
    :func:`scaled_softmax_fwd_plain`; a CUDA tensor launches the kernel or
    raises."""
    if not _checks.on_cuda("scaled_softmax_fwd", x):
        return scaled_softmax_fwd_plain(x, scale)
    code, rows = _check_rows("scaled_softmax_fwd", x)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _masked_kernel()(x.data_ptr(), None, y.data_ptr(), rows, 1, 1,
                              x.shape[-1], 0, 0, 0, float(scale), code,
                              _checks.stream(x))
    _checks.status("scaled_softmax_fwd", rc)
    registry.count(SCALED_SOFTMAX)
    return y


def _mask_view(name, mask, shape):
    """The mask as a [b, n, sq, sk] view of one byte per flag whose keys
    are contiguous (the kernel reads them so); the other broadcast
    dimensions keep stride 0 (no copy at the scores' shape). A mask that
    broadcasts over the keys (last dim 1) is copied at sk flags per row."""
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0  # a copy at the mask's own shape
    if mask.dim() > 4:
        raise ValueError(f"{name}: mask has {mask.dim()} dims; it must "
                         f"broadcast to x {tuple(shape)}")
    try:
        view = mask.expand(shape)
    except RuntimeError as err:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not "
                         f"broadcast to x {tuple(shape)}") from err
    if shape[-1] > 1 and view.stride(-1) != 1:
        keys = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
        keys = keys.expand(*keys.shape[:-1], shape[-1]).contiguous()
        view = keys.expand(shape)
    return view


def scaled_masked_softmax_fwd(x, mask, scale):
    """Softmax over the last dim of x*scale with the keys where ``mask``
    is non-zero masked (set to -10000 before the max, to 0 after the exp),
    in x's dtype. x is [b, n, sq, sk] (or fewer leading dims), fp32 or
    bf16, sk <= 16384; mask (bool, uint8 or any dtype compared with 0)
    broadcasts to x's shape, e.g. [b, 1, sq, sk]. A CPU tensor takes
    :func:`scaled_masked_softmax_fwd_plain`; a CUDA tensor launches the
    kernel or raises."""
    name = "scaled_masked_softmax_fwd"
    if not _checks.on_cuda(name, x, mask):
        return scaled_masked_softmax_fwd_plain(x, mask, scale)
    if not 1 <= x.dim() <= 4:
        raise ValueError(f"{name}: x must be [b, n, sq, sk] or have fewer "
                         f"leading dims, got {tuple(x.shape)}")
    code, rows = _check_rows(name, x)
    shape = (1,) * (4 - x.dim()) + tuple(x.shape)
    m = _mask_view(name, mask, shape)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _masked_kernel()(x.data_ptr(), m.data_ptr(), y.data_ptr(), rows,
                              shape[1], shape[2], shape[3], m.stride(0),
                              m.stride(1), m.stride(2), float(scale), code,
                              _checks.stream(x))
    _checks.status(name, rc)
    registry.count(MASKED_SOFTMAX)
    return y


def softmax_bwd(y, dy, scale):
    """Softmax backward over the last dim: dx = scale * y * (dy - sum(dy *
    y)) for y and dy of one shape and dtype (fp32 or bf16), dx in that
    dtype. A CPU tensor takes :func:`softmax_bwd_plain`; a CUDA tensor
    launches the kernel or raises."""
    if not _checks.on_cuda("softmax_bwd", y, dy):
        return softmax_bwd_plain(y, dy, scale)
    if y.shape != dy.shape or y.dim() < 1 or y.numel() == 0:
        raise ValueError(f"softmax_bwd: y and dy must be one non-empty "
                         f"shape, got {tuple(y.shape)} and {tuple(dy.shape)}")
    if dy.dtype != y.dtype:
        raise TypeError(f"softmax_bwd: dy ({dy.dtype}) must have y's dtype "
                        f"({y.dtype})")
    _checks.contiguous("softmax_bwd", y=y, dy=dy)
    code = _checks.dtype_code("softmax_bwd", y, "y")
    rows = _rows("softmax_bwd", y)
    dx = torch.empty_like(y)
    with torch.cuda.device(y.device):
        rc = _bwd_kernel()(y.data_ptr(), dy.data_ptr(), dx.data_ptr(), rows,
                           y.shape[-1], float(scale), code, _checks.stream(y))
    _checks.status("softmax_bwd", rc)
    registry.count(SOFTMAX_BWD)
    return dx
