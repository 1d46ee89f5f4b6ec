"""Blockwise symmetric int8 quantize and dequantize: the CUDA kernels
(csrc/quant8.cu) and their plain PyTorch versions.

Counterparts of ``apex_tpu/parallel/compression.py`` ``_quant_kernel``
and ``_dequant_kernel`` with the jnp oracle around them
(``block_scales``, ``_quantize_jnp``, ``_dequantize_jnp``). Rows of
``n`` lanes are cut into ``nb = ceil(n / block)`` blocks, the last one
zero-padded; each block has the scale ``max(absmax, 1e-12) / 127`` and
the codes ``clip(round(x / scale), -127, 127)`` (round half to even),
or the codes against scales given from outside (the data-parallel
collectives' shared scales). Dequantize takes int8 codes or the int32
partial sums of those collectives. Kernel, plain version and the JAX
oracle agree bit for bit. The public
functions with the JAX package's names are in
:mod:`apex_tpu_torch.parallel.compression`.

Each direction has two bodies, picked by :func:`quant_plan` and
:func:`dequant_plan`: the streaming bodies read x (quantize) or the codes
(dequantize) as one flat array in 16-byte vectors wherever the rows are
contiguous in the codes' order (the serving cache's full-width rows,
every one-row DDP bucket); the first designs take one element a thread
(ragged rows, other blocks, unaligned views).
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

QMAX = 127.0
QUANTIZE = registry.register("quantize_int8")
DEQUANTIZE = registry.register("dequantize_int8")
# code dtypes of apex_dequant8
CODE_DTYPES = {torch.int8: 0, torch.int32: 1}
# apex_quant8's and apex_dequant8's paths (2 and 3 are planted faults of
# the streaming bodies, passed only by the card checks)
SCALAR, VECTOR = 0, 1
VECTOR_BYTES = 16  # the streaming bodies' vector
# most 16-byte vectors of one block a lane of the streaming quantize holds
# (its kMaxVPL): a block of up to 32 * 4 vectors, 1024 bf16 or 512 fp32
QUANT_MAX_VECTORS_PER_LANE = 4


def _blocks(n: int, block: int) -> int:
    return -(-n // block)


def block_scales(x3d):
    """Per-block scales [..., nb, 1] of blocked fp32 lanes [..., nb, B]:
    absmax / 127, floored so an all-zero block dequantizes to zeros."""
    absmax = torch.amax(torch.abs(x3d), dim=-1, keepdim=True)
    # divided by a tensor, not the Python scalar: on CUDA tensors PyTorch
    # turns a division by a scalar into a product with its reciprocal,
    # which is not the IEEE division JAX and the kernel round to
    return torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, QMAX)


def quantize_rows_plain(x2d, block: int, scales=None):
    """x2d [rows, n] (fp32 or bf16) -> (q [rows, nb, block] int8, scales
    [rows, nb, 1] fp32); given ``scales`` are used, not computed."""
    rows, n = x2d.shape
    nb = _blocks(n, block)
    x = torch.nn.functional.pad(x2d.float(), (0, nb * block - n))
    x = x.reshape(rows, nb, block)
    if scales is None:
        scales = block_scales(x)
    q = torch.clamp(torch.round(x / scales), -QMAX, QMAX).to(torch.int8)
    return q, scales


def dequantize_rows_plain(q, scales, n=None, out_dtype=torch.float32):
    """(q [rows, nb, B] int8 or int32, scales [rows, nb, 1]) -> [rows, n]
    in ``out_dtype`` (default n: every lane, nb * B)."""
    rows, nb, block = q.shape
    out = (q.float() * scales).reshape(rows, nb * block)
    if n is not None:
        out = out[:, :n]
    return out.to(out_dtype)


@functools.lru_cache(maxsize=1)
def _quant_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function("quant8", "apex_quant8",
                           [p, p, p, ctypes.c_longlong, i, i, i, i, i, i, p])


@functools.lru_cache(maxsize=1)
def _dequant_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function("quant8", "apex_dequant8",
                           [p, p, p, ctypes.c_longlong, i, i, i, i, i, i, p])


def quant_plan(rows: int, n: int, nb: int, block: int, in_itemsize: int,
               aligned: bool) -> int:
    """The quantize body for [rows, n] values of ``in_itemsize`` bytes
    into [rows, nb, block] codes: VECTOR where the rows are contiguous in
    the codes' order (n == nb * block, or one row with a ragged tail),
    block is a power of two holding 1 to 32 * QUANT_MAX_VECTORS_PER_LANE
    whole 16-byte vectors of x, and x, the codes and the scales lie on
    16-byte boundaries (``aligned``); else SCALAR, the first design."""
    per_vector = VECTOR_BYTES // in_itemsize
    if (aligned and in_itemsize in (2, 4) and (n == nb * block or rows == 1)
            and per_vector <= block
            <= 32 * QUANT_MAX_VECTORS_PER_LANE * per_vector
            and block & (block - 1) == 0):
        return VECTOR
    return SCALAR


def dequant_plan(rows: int, n: int, nb: int, block: int, code_itemsize: int,
                 out_itemsize: int, aligned: bool) -> int:
    """The dequantize body for [rows, nb, block] codes of
    ``code_itemsize`` bytes into [rows, n] of ``out_itemsize`` bytes:
    VECTOR where the output rows are contiguous in the codes' order (n ==
    nb * block, or one row with a ragged tail), block is a power of two
    holding whole 16-byte code vectors, and codes and output lie on
    16-byte boundaries (``aligned``); else SCALAR, the first design."""
    per_vector = VECTOR_BYTES // code_itemsize
    if (aligned and out_itemsize in (2, 4) and (n == nb * block or rows == 1)
            and block >= per_vector and block & (block - 1) == 0):
        return VECTOR
    return SCALAR


def _launch_dequant(q, scales, out, path):
    """#15 through its C function on ``path``, unchecked and uncounted
    (:func:`dequantize_rows` checks and counts; the card checks force
    paths here)."""
    rows, nb, block = q.shape
    with torch.cuda.device(q.device):
        rc = _dequant_kernel()(q.data_ptr(), scales.data_ptr(),
                               out.data_ptr(), rows, out.shape[1], nb, block,
                               CODE_DTYPES[q.dtype],
                               _checks.DTYPE_CODES[out.dtype], path,
                               _checks.stream(q))
    _checks.status("dequantize_rows", rc)
    return out


def _launch_quant(x2d, q, scales, given: bool, path: int):
    """#14 through its C function on ``path``, unchecked and uncounted
    (:func:`quantize_rows` checks and counts; the card checks force paths
    here): codes into ``q``, scales computed into ``scales`` or read from
    them (``given``)."""
    rows, nb, block = q.shape
    with torch.cuda.device(x2d.device):
        rc = _quant_kernel()(x2d.data_ptr(), q.data_ptr(), scales.data_ptr(),
                             rows, x2d.shape[1], nb, block,
                             _checks.DTYPE_CODES[x2d.dtype], int(given),
                             path, _checks.stream(x2d))
    _checks.status("quantize_rows", rc)
    return q, scales


def quantize_rows(x2d, block: int, scales=None):
    """Blockwise int8 codes of each row of x2d [rows, n] (fp32 or bf16):
    (q [rows, nb, block] int8, scales [rows, nb, 1] fp32), the block
    scales computed in the kernel, or read from ``scales`` (fp32 [rows,
    nb, 1], returned as given) when they are given. A CPU tensor takes
    :func:`quantize_rows_plain`; a CUDA tensor launches the kernel or
    raises."""
    tensors = (x2d,) if scales is None else (x2d, scales)
    if not _checks.on_cuda("quantize_rows", *tensors):
        return quantize_rows_plain(x2d, block, scales)
    if x2d.dim() != 2:
        raise ValueError(f"quantize_rows: x2d must be [rows, n], got "
                         f"{tuple(x2d.shape)}")
    if block < 1:
        raise ValueError(f"quantize_rows: block ({block}) must be >= 1")
    rows, n = x2d.shape
    nb = _blocks(n, block)
    _checks.dtype_code("quantize_rows", x2d, "x2d")
    _checks.contiguous("quantize_rows", x2d=x2d)
    q = torch.empty((rows, nb, block), dtype=torch.int8, device=x2d.device)
    if scales is None:
        out_scales = torch.empty((rows, nb, 1), dtype=torch.float32,
                                 device=x2d.device)
    else:
        if (scales.dtype != torch.float32
                or tuple(scales.shape) != (rows, nb, 1)):
            raise ValueError(f"quantize_rows: scales must be float32 "
                             f"[{rows}, {nb}, 1], got {scales.dtype} "
                             f"{tuple(scales.shape)}")
        _checks.contiguous("quantize_rows", scales=scales)
        out_scales = scales
    if rows == 0 or n == 0:
        return q.zero_(), out_scales
    path = quant_plan(rows, n, nb, block, x2d.element_size(),
                      all(t.data_ptr() % 16 == 0 for t in (x2d, q,
                                                            out_scales)))
    _launch_quant(x2d, q, out_scales, scales is not None, path)
    registry.count(QUANTIZE, flops=2.0 * x2d.numel(),
                   bytes=registry.nbytes(x2d, q, out_scales))
    return q, out_scales


def dequantize_rows(q, scales, n=None, out_dtype=torch.float32):
    """q [rows, nb, B] int8 codes (or int32 partial sums) times their
    fp32 scales [rows, nb, 1] -> [rows, n] in ``out_dtype`` (fp32 or bf16:
    the fp32 product rounded; default n: nb * B). A CPU tensor takes
    :func:`dequantize_rows_plain`; a CUDA tensor launches the kernel or
    raises."""
    if not _checks.on_cuda("dequantize_rows", q, scales):
        return dequantize_rows_plain(q, scales, n, out_dtype)
    if q.dim() != 3:
        raise ValueError(f"dequantize_rows: q must be [rows, nb, B], got "
                         f"{tuple(q.shape)}")
    rows, nb, block = q.shape
    n = nb * block if n is None else n
    code_dtype = CODE_DTYPES.get(q.dtype)
    if code_dtype is None:
        raise TypeError(f"dequantize_rows: q must be int8 or int32, got "
                        f"{q.dtype}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (rows, nb, 1):
        raise ValueError(f"dequantize_rows: scales must be float32 "
                         f"[{rows}, {nb}, 1], got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if not 0 <= n <= nb * block:
        raise ValueError(f"dequantize_rows: n ({n}) must be in [0, "
                         f"{nb * block}]")
    _checks.contiguous("dequantize_rows", q=q, scales=scales)
    out = torch.empty((rows, n), dtype=out_dtype, device=q.device)
    _checks.dtype_code("dequantize_rows", out, "out_dtype")
    if rows == 0 or n == 0:
        return out
    path = dequant_plan(rows, n, nb, block, q.element_size(),
                        out.element_size(),
                        q.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    _launch_dequant(q, scales, out, path)
    registry.count(DEQUANTIZE, flops=float(out.numel()),
                   bytes=registry.nbytes(q, scales, out))
    return out
