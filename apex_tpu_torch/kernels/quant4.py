"""int4 dual quantization: quantize, dequantize and nibble packing, the
CUDA kernels (csrc/quant4.cu) and their plain PyTorch versions.

Counterpart of ``apex_tpu/kernels/quant4.py``: symmetric int4 codes in
[-7, 7] against per-block EFFECTIVE scales ``sq * gmax / (255 * 7)``,
where ``sq`` (uint8, the level-1 scale of a block) is the block's absmax
relative to one fp32 ``gmax`` per bucket. The gather's wire format packs
two codes a byte in SPLIT-HALF order: ``packed[b, j] = (q[b, j] & 0xF) |
(q[b, j + B/2] & 0xF) << 4``; an odd block width pads one zero lane per
row, which ``unpack_int4(..., n=)`` drops again.

:func:`quantize_pack_int4` and :func:`unpack_dequantize_int4` are the
fused forms of the int4 gather (``apex_tpu/kernels/fused_cc.py`` family
(c), its default): quantize+pack on the send side and unpack+dequantize
on the receive side in one pass each, the codes never written out,
bit-identical to the unfused pairs.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``*_plain``), which repeats the JAX
oracle's operations in its order. Kernel, plain version and the oracle
agree bit for bit. On the CPU :func:`dequantize_int4` also takes int32
partial sums, which JAX sends to its plain arithmetic
(``apex_tpu/kernels/quant4.py:189-195``); on the card it takes int8 codes
only (the collectives dequantize their int32 sums with
``kernels/quant.py``). Launches are counted as ``quantize_int4``,
``dequantize_int4``, ``pack_int4``, ``unpack_int4``,
``quantize_pack_int4`` and ``unpack_dequantize_int4``.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

QMAX4 = 7.0
_SCALE_QMAX = 255.0

QUANTIZE = registry.register("quantize_int4")
DEQUANTIZE = registry.register("dequantize_int4")
PACK = registry.register("pack_int4")
UNPACK = registry.register("unpack_int4")
QUANTIZE_PACK = registry.register("quantize_pack_int4")
UNPACK_DEQUANTIZE = registry.register("unpack_dequantize_int4")


def int4_block_scales(absmax):
    """Two-level scales from (shared) per-block absmaxes [nb, 1]: ``(sq
    uint8 [nb, 1], gmax fp32 scalar)``. Divide, multiply by 255, round
    half to even and clip to [1, 255], as JAX does."""
    gmax = torch.clamp_min(torch.amax(absmax), 1e-12)
    sq = torch.clamp(torch.round(absmax / gmax * _SCALE_QMAX), 1.0,
                     _SCALE_QMAX).to(torch.uint8)
    return sq, gmax


def effective_scales(sq, gmax):
    """The dequantization grid the wire format implies: ``float(sq) *
    (gmax / 1785)``, [nb, 1] fp32 (the quotient taken first). Divided by
    a tensor: on CUDA tensors PyTorch turns a division by a Python scalar
    into a product with its reciprocal, which JAX does not round alike."""
    return sq.float() * (gmax / torch.full_like(gmax, _SCALE_QMAX * QMAX4))


def block_absmax(x2d):
    """Each block's absmax [nb, 1] fp32, floored at 1e-12."""
    return torch.clamp_min(torch.amax(torch.abs(x2d), dim=-1, keepdim=True),
                           1e-12)


def two_level_scales(absmax):
    """Both levels and the grid they imply, from per-block absmaxes [nb,
    1]: ``(effective [nb, 1] fp32, sq uint8 [nb, 1], gmax fp32)``."""
    sq, gmax = int4_block_scales(absmax)
    return effective_scales(sq, gmax), sq, gmax


def _pad_even_lanes(q2d):
    """One zero lane on each row of an odd-width block, so the
    split-half layout stays well formed."""
    if q2d.shape[1] % 2:
        q2d = torch.nn.functional.pad(q2d, (0, 1))
    return q2d


# ---------------------------------------------------------------- plain

def quantize_int4_plain(x2d, scales):
    return torch.clamp(torch.round(x2d / scales), -QMAX4, QMAX4).to(
        torch.int8)


def dequantize_int4_plain(q2d, scales):
    return q2d.float() * scales


def pack_int4_plain(q2d):
    q2d = _pad_even_lanes(q2d)
    h = q2d.shape[1] // 2
    lo = q2d[:, :h].int() & 0xF
    hi = q2d[:, h:].int() & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_plain(p2d, n=None):
    p = p2d.int()
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    out = torch.cat([lo, hi], dim=1).to(torch.int8)
    return out if n is None else out[:, :n]


def quantize_pack_int4_plain(x2d, scales):
    return pack_int4_plain(quantize_int4_plain(_pad_even_lanes(x2d), scales))


def unpack_dequantize_int4_plain(p2d, scales, n=None):
    out = dequantize_int4_plain(unpack_int4_plain(p2d), scales)
    return out if n is None else out[:, :n]


# --------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    p, i = _checks.ptr, ctypes.c_int
    args = {"apex_quant4": [p, p, p, ctypes.c_longlong, i, p],
            "apex_dequant4": [p, p, p, ctypes.c_longlong, i, p],
            "apex_pack4": [p, p, ctypes.c_longlong, i, i, p],
            "apex_unpack4": [p, p, ctypes.c_longlong, i, i, p],
            "apex_quant_pack4": [p, p, p, ctypes.c_longlong, i, i, p],
            "apex_unpack_dequant4": [p, p, p, ctypes.c_longlong, i, i,
                                     p]}[symbol]
    return _build.function("quant4", symbol, args)


def _rows(name, t, dtype, what):
    if t.dim() != 2:
        raise ValueError(f"{name}: {what} must be 2-D [nb, B], got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def _scales(name, scales, nb):
    if scales.dtype != torch.float32 or tuple(scales.shape) != (nb, 1):
        raise ValueError(f"{name}: scales must be float32 [{nb}, 1], got "
                         f"{scales.dtype} {tuple(scales.shape)}")


def _unpack_width(name, h, n):
    n = 2 * h if n is None else n
    if not 0 <= n <= 2 * h:
        raise ValueError(f"{name}: n ({n}) must be in [0, {2 * h}]")
    return n


def _launch(name, counter, symbol, t, *args, work=()):
    with torch.cuda.device(t.device):
        rc = _kernel(symbol)(*args, _checks.stream(t))
    _checks.status(name, rc)
    registry.count(counter, flops=2.0 * t.numel(),
                   bytes=registry.nbytes(t, *work))


def quantize_int4(x2d, scales):
    """x2d [nb, B] fp32 against effective scales [nb, 1] fp32 -> int4
    codes as int8 [nb, B]: ``clip(rint(x / s), -7, 7)``."""
    if not _checks.on_cuda("quantize_int4", x2d, scales):
        return quantize_int4_plain(x2d, scales)
    _rows("quantize_int4", x2d, torch.float32, "x2d")
    nb, b = x2d.shape
    _scales("quantize_int4", scales, nb)
    _checks.contiguous("quantize_int4", x2d=x2d, scales=scales)
    q = torch.empty((nb, b), dtype=torch.int8, device=x2d.device)
    if q.numel():
        _launch("quantize_int4", QUANTIZE, "apex_quant4", x2d,
                x2d.data_ptr(), scales.data_ptr(), q.data_ptr(), nb, b,
                work=(scales, q))
    return q


def dequantize_int4(q2d, scales):
    """int4 codes [nb, B] (int8) times effective scales [nb, 1] -> fp32.
    On the CPU int32 partial sums take the same arithmetic, as in JAX."""
    if not _checks.on_cuda("dequantize_int4", q2d, scales):
        return dequantize_int4_plain(q2d, scales)
    _rows("dequantize_int4", q2d, torch.int8, "q2d")
    nb, b = q2d.shape
    _scales("dequantize_int4", scales, nb)
    _checks.contiguous("dequantize_int4", q2d=q2d, scales=scales)
    out = torch.empty((nb, b), dtype=torch.float32, device=q2d.device)
    if out.numel():
        _launch("dequantize_int4", DEQUANTIZE, "apex_dequant4", q2d,
                q2d.data_ptr(), scales.data_ptr(), out.data_ptr(), nb, b,
                work=(scales, out))
    return out


def pack_int4(q2d):
    """int4 codes [nb, B] (int8) -> uint8 [nb, ceil(B/2)] split-half
    nibbles (an odd B pads one zero lane a row)."""
    if not _checks.on_cuda("pack_int4", q2d):
        return pack_int4_plain(q2d)
    _rows("pack_int4", q2d, torch.int8, "q2d")
    _checks.contiguous("pack_int4", q2d=q2d)
    nb, b = q2d.shape
    h = -(-b // 2)
    p = torch.empty((nb, h), dtype=torch.uint8, device=q2d.device)
    if p.numel():
        _launch("pack_int4", PACK, "apex_pack4", q2d, q2d.data_ptr(),
                p.data_ptr(), nb, b, h, work=(p,))
    return p


def unpack_int4(p2d, n=None):
    """uint8 nibbles [nb, H] -> sign-extended int4 codes int8 [nb, n]
    (default n: 2H; ``n`` drops an odd block's pad lane)."""
    if not _checks.on_cuda("unpack_int4", p2d):
        return unpack_int4_plain(p2d, n)
    _rows("unpack_int4", p2d, torch.uint8, "p2d")
    _checks.contiguous("unpack_int4", p2d=p2d)
    nb, h = p2d.shape
    n = _unpack_width("unpack_int4", h, n)
    out = torch.empty((nb, n), dtype=torch.int8, device=p2d.device)
    if out.numel():
        _launch("unpack_int4", UNPACK, "apex_unpack4", p2d, p2d.data_ptr(),
                out.data_ptr(), nb, h, n, work=(out,))
    return out


def quantize_pack_int4(x2d, scales):
    """The send side of the int4 gather in one pass: x2d [nb, B] fp32
    against effective scales [nb, 1] -> uint8 nibbles [nb, ceil(B/2)],
    ``pack_int4(quantize_int4(x2d, scales))`` (an odd B pads one zero
    value a row)."""
    if not _checks.on_cuda("quantize_pack_int4", x2d, scales):
        return quantize_pack_int4_plain(x2d, scales)
    _rows("quantize_pack_int4", x2d, torch.float32, "x2d")
    nb, b = x2d.shape
    _scales("quantize_pack_int4", scales, nb)
    _checks.contiguous("quantize_pack_int4", x2d=x2d, scales=scales)
    h = -(-b // 2)
    p = torch.empty((nb, h), dtype=torch.uint8, device=x2d.device)
    if p.numel():
        _launch("quantize_pack_int4", QUANTIZE_PACK, "apex_quant_pack4", x2d,
                x2d.data_ptr(), scales.data_ptr(), p.data_ptr(), nb, b, h,
                work=(scales, p))
    return p


def unpack_dequantize_int4(p2d, scales, n=None):
    """The receive side of the int4 gather in one pass: uint8 nibbles
    [nb, H] times effective scales [nb, 1] -> fp32 [nb, n] (default n:
    2H), ``dequantize_int4(unpack_int4(p2d, n), scales)``."""
    if not _checks.on_cuda("unpack_dequantize_int4", p2d, scales):
        return unpack_dequantize_int4_plain(p2d, scales, n)
    _rows("unpack_dequantize_int4", p2d, torch.uint8, "p2d")
    nb, h = p2d.shape
    _scales("unpack_dequantize_int4", scales, nb)
    _checks.contiguous("unpack_dequantize_int4", p2d=p2d, scales=scales)
    n = _unpack_width("unpack_dequantize_int4", h, n)
    out = torch.empty((nb, n), dtype=torch.float32, device=p2d.device)
    if out.numel():
        _launch("unpack_dequantize_int4", UNPACK_DEQUANTIZE,
                "apex_unpack_dequant4", p2d, p2d.data_ptr(),
                scales.data_ptr(), out.data_ptr(), nb, h, n,
                work=(scales, out))
    return out
