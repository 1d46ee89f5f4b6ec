"""Multi-tensor scale and axpby with overflow detection (amp's unscale):
the CUDA kernel (csrc/multi_tensor_scale.cu) and its plain PyTorch
version.

The port's counterpart of ``apex_tpu/ops/multi_tensor.py``
``multi_tensor_scale`` and ``multi_tensor_axpby``, jnp loops that XLA
fuses (no Pallas kernel). One launch covers up to :data:`MAX_TENSORS`
tensors of one dtype combination; :func:`scale` and :func:`axpby` make as
many launches as the lists need. The entry points are
:func:`apex_tpu_torch.ops.multi_tensor.multi_tensor_scale` and
``multi_tensor_axpby``.

On the card the wrappers launch the streaming body (:data:`STREAM`): each
tensor a scalar head, vectors of :func:`vector_width` elements and a
scalar tail, as ``kernels/optim.py`` ``adam_plan`` covers it.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, optim, registry

MAX_TENSORS = 64  # tensors in one launch's table (kMaxTensors in the .cu)
SCALE, AXPBY = 0, 1  # mode codes of apex_multi_tensor_scale
# path codes of apex_multi_tensor_scale: the first design and the
# streaming body that the wrappers launch
FIRST, STREAM = 0, 1
SCALE_KERNEL = registry.register("multi_tensor_scale")


def _raise_flag(flag, rs):
    """Set ``flag`` to 1 where some tensor of ``rs`` holds inf or NaN (on
    the device, no host synchronisation)."""
    if rs:
        bad = torch.stack([~torch.isfinite(r).all() for r in rs]).any()
        flag.copy_(torch.where(bad, 1.0, flag))


def scale_plain(flag, xs, outs, scale):
    """``out = x * scale`` in fp32 for each pair, written into out in its
    own dtype (out may be x); ``flag`` (a one-element fp32 tensor) set to
    1 where some fp32 product is not finite. ``scale`` is a one-element
    fp32 tensor on their device."""
    s = scale.reshape(())
    rs = [x.float() * s for x in xs]
    _raise_flag(flag, rs)
    for r, out in zip(rs, outs):
        out.copy_(r)


def axpby_plain(flag, xs, ys, outs, a, b):
    """``out = a * x + b * y`` in fp32 (two products, then the sum), as
    :func:`scale_plain` writes and flags it."""
    device = flag.device
    a = torch.full((), a, dtype=torch.float32, device=device)
    b = torch.full((), b, dtype=torch.float32, device=device)
    rs = [a * x.float() + b * y.float() for x, y in zip(xs, ys)]
    _raise_flag(flag, rs)
    for r, out in zip(rs, outs):
        out.copy_(r)


def vector_width(dtypes):
    """Elements in one vector of the streaming body for lists of
    ``dtypes`` (x's, y's in axpby, out's): 8 where all are bf16 (one
    16-byte access), else 4 (16 bytes of fp32, 8 of bf16)."""
    return 8 if all(d == torch.bfloat16 for d in dtypes) else 4


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function("multi_tensor_scale", "apex_multi_tensor_scale",
                           [p, p, p, p, p, i, i, i, i, i, p, f, f, p, i, i,
                            p])


def _check(name, flag, scalar, lists):
    if flag.dtype != torch.float32 or flag.numel() != 1:
        raise ValueError(f"{name}: the flag must be a one-element float32 "
                         f"tensor")
    if scalar is not None and (scalar.dtype != torch.float32
                               or scalar.numel() != 1):
        raise ValueError(f"{name}: scale must be a one-element float32 "
                         f"tensor")
    if len({len(ts) for ts in lists}) != 1:
        raise ValueError(f"{name}: lists of {[len(ts) for ts in lists]} "
                         f"tensors")
    for k, ts in enumerate(zip(*lists)):
        for t in ts:
            _checks.dtype_code(name, t, f"tensor {k}")
        if any(t.shape != ts[-1].shape for t in ts):
            raise ValueError(f"{name}: tensor {k}: shapes differ: "
                             f"{[tuple(t.shape) for t in ts]}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError(f"{name}: tensor {k} must be contiguous")


def launch(mode, flag, xs, ys, outs, scale_ptr, a, b, fault=0,
           path=STREAM):
    """Kernel runs over the lists through the C function (``path``:
    :data:`STREAM` or the first design; ``fault``: 0, or a planted
    fault's code); returns the launches made. The wrappers below check
    and count; this does neither."""
    fn = _kernel()
    lists = dict(x=xs, y=ys if mode == AXPBY else [None] * len(xs), out=outs)
    launches = 0
    for (xd, yd, od), index, t, sizes, heads, n in optim._runs(
            lists, ("x", "y", "out")):
        width = vector_width([ts[index[0]].dtype for ts in lists.values()
                              if ts[index[0]] is not None])
        with torch.cuda.device(flag.device):
            rc = fn(t["x"], t["y"], t["out"], sizes,
                    None if path == FIRST else heads(width), n, xd,
                    max(yd, 0), od, mode, scale_ptr, float(a), float(b),
                    flag.data_ptr(), fault, path, _checks.stream(flag))
        _checks.status("multi_tensor_scale", rc)
        launches += 1
    return launches


def scale(flag, xs, outs, scale):
    """``out = x * scale`` over lists of fp32 or bf16 tensors (out may be
    x), ``flag`` set to 1 where some fp32 product is not finite. ``flag``
    and ``scale`` are one-element fp32 tensors on the tensors' device
    (no host synchronisation). CPU tensors take :func:`scale_plain`;
    CUDA tensors launch the streaming kernel, once per
    :data:`MAX_TENSORS` tensors of one dtype pair, or raise."""
    if not _checks.on_cuda("multi_tensor_scale", flag, scale, *xs, *outs):
        return scale_plain(flag, xs, outs, scale)
    _check("multi_tensor_scale", flag, scale, (xs, outs))
    registry.count_all(
        SCALE_KERNEL, launch(SCALE, flag, xs, xs, outs, scale.data_ptr(), 0.0,
                             0.0),
        flops=2.0 * sum(x.numel() for x in xs),
        bytes=registry.nbytes(xs, outs))


def axpby(flag, xs, ys, outs, a, b):
    """``out = a * x + b * y`` over lists of fp32 or bf16 tensors (host
    floats a and b, rounded to fp32), flagged as :func:`scale` flags it.
    CPU tensors take :func:`axpby_plain`; CUDA tensors launch the kernel
    or raise."""
    if not _checks.on_cuda("multi_tensor_axpby", flag, *xs, *ys, *outs):
        return axpby_plain(flag, xs, ys, outs, a, b)
    _check("multi_tensor_axpby", flag, None, (xs, ys, outs))
    registry.count_all(
        SCALE_KERNEL, launch(AXPBY, flag, xs, ys, outs, None, a, b),
        flops=4.0 * sum(x.numel() for x in xs),
        bytes=registry.nbytes(xs, ys, outs))
