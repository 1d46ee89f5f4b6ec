"""Block-quantized gradient collectives with error feedback, and the
int8 block core they share with the int8 KV cache.

Counterpart of ``apex_tpu/parallel/compression.py`` on
``torch.distributed``. A flat bucket (or each row of a tensor) is cut
into ``block_size``-lane blocks, the ragged tail zero-padded.

- ``mode="int8"``: each block's scale is ``max(absmax, 1e-12) / 127``;
  the collectives combine the replicas' scales with an all-reduce MAX
  (JAX's ``lax.pmax``) so every replica quantizes on one grid, round
  half to even onto [-127, 127], and sum the codes as **int32 partials**
  (an all-reduce SUM), dequantized with the shared scales.
- ``mode="int4"``: dual quantization (:mod:`apex_tpu_torch.kernels.quant4`):
  the replicas' raw block absmaxes are combined with MAX, and every
  replica derives the same two-level ``(sq uint8, gmax fp32)`` scales
  from them; codes in [-7, 7], int32 partials as in int8.
- ``mode="bf16"``: the payload is a bf16 cast; no residual.

The int modes return the local quantization error ``x - q * s`` (fp32,
the plain arithmetic, as JAX computes it with its oracle) as the
error-feedback residual, which the caller adds to the next step's
gradient. As in JAX the int payloads travel as int32 partials (a
reduction over 4-bit lanes is a feature neither library has);
:func:`estimate_allreduce_bytes` models the wire a quantized collective
would ship. The quantize and dequantize kernels (``kernels/quant.py``,
``kernels/quant4.py``) run on CUDA tensors, their plain versions on CPU
tensors; every result is bit-identical to the JAX package's.

The ``lax`` collectives map to ``torch.distributed`` over the axis's
process group (:mod:`apex_tpu_torch.parallel.groups`), with
``async_op=False``: ``psum`` -> ``all_reduce(SUM)``, ``pmax`` ->
``all_reduce(MAX)``, ``psum_scatter(tiled)`` -> ``reduce_scatter_tensor``,
``all_gather(tiled)`` -> ``all_gather_into_tensor``. The int4 gather takes
JAX's default, fused form: quantize+pack and unpack+dequantize in one
kernel each. Each collective is accounted with
:func:`apex_tpu_torch.telemetry.comm.record_collective` where JAX records
it, at its semantic wire width.

    q, s = quantize_rows_blockwise(x)        # x [..., F]
    x_hat = dequantize_rows_blockwise(q, s, n=x.shape[-1])
    total, residual = psum_compressed(flat, "dp", mode="int4",
                                      residual=residual)
"""

import warnings

import torch
import torch.distributed as dist

from apex_tpu_torch.kernels import quant, quant4
from apex_tpu_torch.kernels.quant import block_scales  # noqa: F401
from apex_tpu_torch.parallel.groups import axis_group
from apex_tpu_torch.telemetry import comm as _telemetry_comm

# lanes per scale: 0.4 % scale overhead at 256
BLOCK_SIZE = 256

# compression modes whose collectives return an error-feedback residual
RESIDUAL_MODES = ("int8", "int4")


def needs_residual(mode) -> bool:
    """Whether ``mode`` makes the compressed collectives stateful:
    returning ``(result, new_residual)`` for error feedback."""
    return mode in RESIDUAL_MODES


def num_blocks(n: int, block_size: int = BLOCK_SIZE) -> int:
    return -(-n // block_size)


def pad_to_blocks(flat, block_size: int = BLOCK_SIZE):
    """[n] -> [nblocks, block_size] fp32, ragged tail zero-padded."""
    n = flat.shape[0]
    nb = num_blocks(n, block_size)
    flat = torch.nn.functional.pad(flat.float(), (0, nb * block_size - n))
    return flat.reshape(nb, block_size)


def quantize_blockwise(flat, block_size: int = BLOCK_SIZE, scales=None):
    """[n] -> (q [nblocks, block_size] int8, scales [nblocks, 1] fp32).
    ``scales=None`` computes local per-block scales; pass shared
    (MAX-combined) scales so every replica lands on the same grid."""
    n = flat.shape[0]
    nb = num_blocks(n, block_size)
    if scales is not None:
        scales = scales.reshape(1, nb, 1)
    q, s = quant.quantize_rows(flat.reshape(1, n), block_size, scales)
    return q.reshape(nb, block_size), s.reshape(nb, 1)


def dequantize_blockwise(q2d, scales, n=None):
    """(q [nblocks, b] int8 codes or int32 partial sums, scales
    [nblocks, 1]) -> [n] fp32."""
    nb, b = q2d.shape
    out = quant.dequantize_rows(q2d.reshape(1, nb, b),
                                scales.reshape(1, nb, 1), n)
    return out.reshape(-1)


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


def init_residual(grads):
    """Zero error-feedback residual shaped like ``grads`` (a tensor, or a
    dict or list of them): fp32, since the residual accumulates
    sub-ulp-of-bf16 errors."""
    if isinstance(grads, torch.Tensor):
        return torch.zeros(grads.shape, dtype=torch.float32,
                           device=grads.device)
    if isinstance(grads, dict):
        return {k: init_residual(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(init_residual(v) for v in grads)
    raise TypeError(f"init_residual: expected a tensor, dict or list, got "
                    f"{type(grads).__name__}")


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _error(x2d, q, scales):
    """The local quantization error ``x - q * s`` in the block layout:
    the plain fp32 arithmetic, as JAX computes it with its oracle."""
    return x2d - q.float() * scales


def _all_reduce(t, op, group):
    dist.all_reduce(t, op=op, group=group)
    return t


def _reduce_scatter(out, x, group):
    # deprecated in newer torch releases, but in every one the port runs on
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*reduce_scatter_tensor")
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x, group):
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor")
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _record(op, elements, dtype, group, mode, **kw):
    """Account one collective of ``group`` (:mod:`apex_tpu_torch.
    telemetry.comm`), at the places and widths the JAX package records
    them."""
    _telemetry_comm.record_collective(
        op, elements=elements, dtype=dtype, axis_name="dp"
        if group is dist.group.WORLD else group,
        world=dist.get_world_size(group), mode=mode, **kw)


def _shared_scales(x2d, group):
    """Per-replica block scales (absmax / 127) combined to the replica
    set's max: every replica quantizes on the same grid."""
    scales = block_scales(x2d)
    _record("pmax", scales.numel(), torch.float32, group, "int8")
    return _all_reduce(scales, dist.ReduceOp.MAX, group)


def _shared_int4_scales(x2d, group):
    """The int4 scale agreement: MAX-combine the raw fp32 block absmaxes,
    then derive ``(sq, gmax)`` from the shared absmaxes on every replica
    (a deterministic function, so the grids agree and the int32 sum is
    exact). Returns the effective [nblocks, 1] fp32 scales."""
    absmax = quant4.block_absmax(x2d)
    _record("pmax", absmax.numel(), torch.float32, group, "int4")
    absmax = _all_reduce(absmax, dist.ReduceOp.MAX, group)
    return quant4.two_level_scales(absmax)[0]


def _effective(flat, residual, block_size):
    """The fp32 payload (gradient plus residual) in block layout."""
    g = flat.float()
    if residual is not None:
        g = g + residual.float()
    return pad_to_blocks(g, block_size)


def _psum_int4(flat, group, *, residual, block_size=BLOCK_SIZE):
    """int4 body of :func:`psum_compressed`: quantize on the shared
    two-level grid, sum int32 partials, dequantize; the residual in the
    flat domain."""
    n = flat.shape[0]
    x2d = _effective(flat, residual, block_size)
    scales = _shared_int4_scales(x2d, group)
    q = quant4.quantize_int4(x2d, scales)
    _record("psum", q.numel(), torch.int8, group, "int4", bits=4,
            emulated=True)
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    out = dequantize_blockwise(total, scales, n=n)
    return out, _error(x2d, q, scales).reshape(-1)[:n]


def psum_compressed(flat, axis_name, *, mode="int8", residual=None,
                    block_size: int = BLOCK_SIZE):
    """All-reduce-sum of a flat buffer with a compressed payload.

    Returns ``(summed flat, new_residual)``. int8 and int4: the sum is
    fp32 and ``new_residual`` the fp32 local quantization error to feed
    back next step (``residual=None`` starts from zeros). bf16: the
    payload is a bf16 cast, the result is cast back to ``flat.dtype``,
    and the residual passes through unchanged (None stays None)."""
    group = axis_group(axis_name)
    if mode == "bf16":
        _record("psum", flat.numel(), torch.bfloat16, group, "bf16")
        out = _all_reduce(flat.to(torch.bfloat16, copy=True),
                          dist.ReduceOp.SUM, group)
        return out.to(flat.dtype), residual
    if mode == "int4":
        return _psum_int4(flat, group, residual=residual,
                          block_size=block_size)
    if mode != "int8":
        raise ValueError(f"unknown compression mode {mode!r}")
    n = flat.shape[0]
    x2d = _effective(flat, residual, block_size)
    scales = _shared_scales(x2d, group)
    q, _ = quantize_blockwise(x2d.reshape(-1), block_size, scales)
    _record("psum", q.numel(), torch.int8, group, "int8", emulated=True)
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    out = dequantize_blockwise(total, scales, n=n)
    return out, _error(x2d, q, scales).reshape(-1)[:n]


def psum_compressed_blocks(x2d, axis_name, *, scale_mult=None):
    """All-reduce-sum of an already block-shaped ``[nblocks, block]`` fp32
    buffer with the int8 payload: the bucket-domain primitive of the
    overlapped step. ``x2d`` is the effective gradient (residual already
    added by the caller).

    ``scale_mult`` folds a constant post-sum multiply (e.g. the
    ``1/world`` averaging) into the dequantization scales: an [nblocks,
    1] multiply instead of a pass over the payload, at most one fp32
    rounding per element away from dividing afterwards (``None``: the
    order of :func:`psum_compressed`).

    Returns ``(summed fp32 [nblocks * block] flat, err2d)``, ``err2d`` the
    local quantization error in the same block layout (the next step's
    residual, zero pad tail included)."""
    group = axis_group(axis_name)
    scales = _shared_scales(x2d, group)
    q, _ = quantize_blockwise(x2d.reshape(-1), x2d.shape[1], scales)
    _record("psum", q.numel(), torch.int8, group, "int8", emulated=True)
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    out_scales = scales if scale_mult is None else scales * torch.full(
        (), scale_mult, dtype=torch.float32, device=scales.device)
    return dequantize_blockwise(total, out_scales), _error(x2d, q, scales)


def psum_scatter_compressed(flat, axis_name, *, mode="int8", residual=None,
                            block_size: int = BLOCK_SIZE):
    """ZeRO gradient sync: reduce-scatter with a compressed payload.

    ``flat``'s length must be a multiple of ``world * block_size`` (int8,
    int4) or ``world`` (bf16). Returns ``(this rank's summed shard fp32
    [len / world], new_residual)``; the residual is full length (the
    error lives where the local gradient was quantized, not where the
    shard landed)."""
    group = axis_group(axis_name)
    world = dist.get_world_size(group)
    if mode == "bf16":
        x = flat.to(torch.bfloat16)
        if x.shape[0] % world:
            raise ValueError(f"psum_scatter_compressed: length "
                             f"{x.shape[0]} is not a multiple of the world "
                             f"size {world}")
        shard = torch.empty(x.shape[0] // world, dtype=torch.bfloat16,
                            device=x.device)
        _record("psum_scatter", x.numel(), torch.bfloat16, group, "bf16")
        return _reduce_scatter(shard, x, group).float(), residual
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown compression mode {mode!r}")
    x2d = _effective(flat, residual, block_size)
    nb = x2d.shape[0]
    if nb % world:
        raise ValueError(f"psum_scatter_compressed: {nb} blocks of "
                         f"{block_size} do not split over {world} ranks")
    if mode == "int4":
        scales = _shared_int4_scales(x2d, group)
        q = quant4.quantize_int4(x2d, scales)
    else:
        scales = _shared_scales(x2d, group)
        q, _ = quantize_blockwise(x2d.reshape(-1), block_size, scales)
    per = nb // world
    total = torch.empty((per, block_size), dtype=torch.int32,
                        device=q.device)
    _record("psum_scatter", q.numel(), torch.int8, group, mode,
            bits=4 if mode == "int4" else None, emulated=True)
    _reduce_scatter(total, q.to(torch.int32), group)
    rank = dist.get_rank(group)
    shard = dequantize_blockwise(total, scales[rank * per:(rank + 1) * per])
    return shard, _error(x2d, q, scales).reshape(-1)


def all_gather_compressed(shard, axis_name, *, mode="bf16",
                          block_size: int = BLOCK_SIZE):
    """ZeRO parameter gather: all-gather with a compressed payload. Each
    rank quantizes its own shard on LOCAL scales (nothing is summed, so
    no MAX exchange) and every receiver dequantizes the concatenation.
    Returns the full fp32 flat vector."""
    group = axis_group(axis_name)
    if mode == "bf16":
        _record("all_gather", shard.numel(), torch.bfloat16, group, "bf16")
        return _all_gather(shard.to(torch.bfloat16), group).float()
    if mode == "int4":
        return _all_gather_int4(shard, group, block_size=block_size)
    if mode != "int8":
        raise ValueError(f"unknown compression mode {mode!r}")
    q, scales = quantize_blockwise(shard, block_size)
    _record("all_gather", q.numel(), torch.int8, group, "int8")
    _record("all_gather", scales.numel(), torch.float32, group, "int8")
    return dequantize_blockwise(_all_gather(q, group),
                                _all_gather(scales, group))


def _all_gather_int4(shard, group, *, block_size=BLOCK_SIZE):
    """The int4 gather in JAX's default, fused form: quantize on LOCAL
    two-level scales and pack the nibbles in one kernel, ship uint8
    half-bytes, uint8 block scales and one fp32 a rank, unpack and
    dequantize in one kernel. Bit-identical to the unfused pairs
    (quantize, pack; unpack, dequantize) that JAX takes with its
    ``fused_cc`` gate off."""
    x2d = pad_to_blocks(shard, block_size)
    nb = x2d.shape[0]
    scales, sq, gmax = quant4.two_level_scales(quant4.block_absmax(x2d))
    packed = quant4.quantize_pack_int4(x2d, scales)
    for t in (packed, sq, gmax.reshape(1)):
        _record("all_gather", t.numel(), t.dtype, group, "int4")
    p_full = _all_gather(packed, group)
    sq_full = _all_gather(sq, group)
    gmax_full = _all_gather(gmax.reshape(1), group)
    gmax_rows = gmax_full.repeat_interleave(nb).reshape(-1, 1)
    # divided by a tensor (IEEE, as JAX), never by the Python scalar
    s_full = sq_full.float() * (
        gmax_rows / torch.full_like(gmax_rows, 255.0 * quant4.QMAX4))
    return quant4.unpack_dequantize_int4(p_full, s_full).reshape(-1)


# ---------------------------------------------------------------------------
# comm-byte accounting
# ---------------------------------------------------------------------------

def estimate_allreduce_bytes(n, *, world=8, compress=None,
                             block_size: int = BLOCK_SIZE,
                             dtype_bytes: int = 4):
    """Estimated bytes EACH replica transmits for one gradient all-reduce
    of ``n`` elements, ring model: ``2*(w-1)/w * payload``. int8 counts
    the wire a quantized all-reduce would ship (1 byte an element, fp32
    block scales and the scale MAX exchange), int4 half a byte, uint8
    block scales, one fp32 and the absmax exchange, bf16 2 bytes. A
    MODEL: the collectives here ship int32 partials."""
    if world <= 1:
        return 0
    ring = 2.0 * (world - 1) / world
    if compress is None:
        payload = n * dtype_bytes
    elif compress == "bf16":
        payload = n * 2
    elif compress == "int8":
        nb = num_blocks(n, block_size)
        payload = n * 1 + nb * 4          # int8 lanes + shared fp32 scales
        payload += nb * 4                 # the scale MAX exchange
    elif compress == "int4":
        nb = num_blocks(n, block_size)
        payload = n * 0.5 + nb * 1 + 4    # packed nibbles + uint8 block
        #                                   scales + the fp32 bucket scale
        payload += nb * 4                 # the absmax MAX exchange (fp32)
    else:
        raise ValueError(f"unknown compression mode {compress!r}")
    return int(round(ring * payload))
