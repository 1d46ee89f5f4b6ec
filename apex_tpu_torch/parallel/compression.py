"""Blockwise symmetric int8 quantization: the core of the compressed
collectives, and the int8 KV cache's primitive.

Counterpart of the int8 block core of ``apex_tpu/parallel/compression.py``
(``BLOCK_SIZE`` through ``dequantize_rows_blockwise``): a flat bucket or
each row of a tensor is cut into ``block_size``-lane blocks (the ragged
tail zero-padded), each block gets its own scale ``max(absmax, 1e-12) /
127``, and values round half to even onto the int8 grid [-127, 127].
The quantize and dequantize kernels (:mod:`apex_tpu_torch.kernels.quant`)
run on CUDA tensors, their plain versions on CPU tensors; both are
bit-identical to the JAX package's oracle. The compressed collectives,
error feedback and the int4 modes come with the data-parallel slice.

    q, s = quantize_rows_blockwise(x)        # x [..., F]
    x_hat = dequantize_rows_blockwise(q, s, n=x.shape[-1])
"""

import torch

from apex_tpu_torch.kernels import quant
from apex_tpu_torch.kernels.quant import block_scales  # noqa: F401

# lanes per scale: 0.4 % scale overhead at 256
BLOCK_SIZE = 256


def num_blocks(n: int, block_size: int = BLOCK_SIZE) -> int:
    return -(-n // block_size)


def pad_to_blocks(flat, block_size: int = BLOCK_SIZE):
    """[n] -> [nblocks, block_size] fp32, ragged tail zero-padded."""
    n = flat.shape[0]
    nb = num_blocks(n, block_size)
    flat = torch.nn.functional.pad(flat.float(), (0, nb * block_size - n))
    return flat.reshape(nb, block_size)


def quantize_blockwise(flat, block_size: int = BLOCK_SIZE):
    """[n] -> (q [nblocks, block_size] int8, scales [nblocks, 1] fp32),
    the per-block scales computed here (JAX's ``scales=`` for shared
    scales comes with the collectives)."""
    n = flat.shape[0]
    nb = num_blocks(n, block_size)
    q, s = quant.quantize_rows(flat.reshape(1, n), block_size)
    return q.reshape(nb, block_size), s.reshape(nb, 1)


def dequantize_blockwise(q2d, scales, n=None):
    """(q [nblocks, b] int8 (int32 on the CPU), scales [nblocks, 1]) ->
    [n] fp32."""
    nb, b = q2d.shape
    out = quant.dequantize_rows(q2d.reshape(1, nb, b),
                                scales.reshape(1, nb, 1))
    out = out.reshape(-1)
    return out if n is None else out[:n]


def quantize_rows_blockwise(x, block_size: int = BLOCK_SIZE):
    """Per-row lane-blocked symmetric int8: ``[..., F]`` -> ``(q [..., nb,
    block] int8, scales [..., nb, 1] fp32)``. Every leading-dim row (a
    cache position in the KV cache) is quantized against its own block
    scales, so appending a position never re-quantizes the others."""
    lead, n = x.shape[:-1], x.shape[-1]
    q, s = quant.quantize_rows(x.reshape(-1, n).contiguous(), block_size)
    nb = q.shape[1]
    return q.reshape(*lead, nb, block_size), s.reshape(*lead, nb, 1)


def dequantize_rows_blockwise(q, scales, n=None, out_dtype=torch.float32):
    """Inverse of :func:`quantize_rows_blockwise`: ``(q [..., nb, block],
    scales [..., nb, 1])`` -> ``[..., n]`` (default n: nb * block lanes,
    keeping the zero-padded tail), fp32 unless ``out_dtype`` asks for
    bf16 (the fp32 product rounded, as a cast after it)."""
    lead = q.shape[:-2]
    nb, block = q.shape[-2:]
    out = quant.dequantize_rows(q.reshape(-1, nb, block).contiguous(),
                                scales.reshape(-1, nb, 1).contiguous(), n,
                                out_dtype)
    return out.reshape(*lead, out.shape[-1])
