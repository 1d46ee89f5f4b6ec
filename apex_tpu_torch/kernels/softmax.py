"""Causal softmax forward and softmax backward: the CUDA kernels
(csrc/softmax.cu) and their plain PyTorch versions.

Counterparts of ``apex_tpu/kernels/softmax.py`` ``_causal_fwd`` and
``_bwd_rows``. The autograd entry point is
:func:`apex_tpu_torch.transformer.functional.fused_softmax.scaled_upper_triang_masked_softmax`.
The plain and masked scaled softmax kernels of that module come with the
BERT slice.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

MASK_VALUE = -10000.0
MAX_KEYS = 16384  # the forward stages a row of fp32 scores in shared memory
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
