"""MLA latent-cache decode attention for one token step: the CUDA kernel
(csrc/mla_decode.cu) and its plain PyTorch version.

Counterpart of ``apex_tpu/contrib/mla_decode.py``. The absorbed decode
of :class:`apex_tpu_torch.models.mla.MLAAttention` scores each query
against the per-token latent rows c_t = [normed kv latent | rotated
k_pe], shared by every head, and reuses the first ``lat`` columns of
the same rows as values:

    scores[n, t] = (q_full[n] . c_t) * scale,   q_full = [q_lat | q_pe]
    ctx_lat[n]   = softmax_t(scores) @ c[:, :lat]

so K and V are two views of one buffer. Rows at ``t >= length`` are
masked (-1e30) in the plain version and never read by the kernel.

There is no switch here as JAX's ``APEX_TPU_MLA_FLASH`` gate, which only
chooses between the TPU and interpret mode: :func:`use_flash` is true
iff :func:`choose_block` finds a tile for the cache, on any device, so
the model takes the same branch as JAX does with its kernel on. On a
CUDA tensor :func:`mla_flash_decode` launches the kernel or raises; on a
CPU tensor it runs :func:`mla_decode_reference`.

The kernel has two bodies, and :func:`mla_plan` picks one from the
shapes and dtypes: the tensor-core body (bf16 q and cache, the model's
case) splits each batch row's live range, read on the device, into
parts of whole 16-key steps (:func:`split_keys`) and merges them in the
same launch through scratch and the counters of
:mod:`apex_tpu_torch.kernels.kv_attention`; the first design (the other
dtypes and widths) cuts the buffer into chunks (:func:`split_rows`) and
merges in a second launch.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from apex_tpu_torch.kernels import _build, _checks, kv_attention, registry

NEG_INF = -1e30
DEFAULT_BLOCK_T = 512
MLA_DECODE = registry.register("mla_decode")

# the first design's block shape (csrc/mla_decode.cu): a group of 16
# heads, 16 cache rows a tile, at most 512 latent columns, rows of at
# most 1024 (at most 202 KB of shared memory a block)
HEADS_PER_BLOCK, ROWS_PER_TILE, MAX_LAT, MAX_L = 16, 16, 512, 1024

# apex_mla_decode's paths (2 and 3 are planted faults of the tensor-core
# body, passed only by the card checks)
FIRST_DESIGN, TENSOR_CORES = 0, 1
# the tensor-core body (csrc/mla_decode.cu `mma_mla_decode`): lat 512,
# 16-key steps, STAGES stages of STAGE_KEYS cache rows, at most
# KERNEL_MAX_SPLITS splits merged through a tree of fan-in 4 with
# COUNTERS_PER_CELL counters a (batch row, head group); the plan asks for
# at most MAX_SPLITS, and a split takes at least MIN_SPLIT_STEPS steps
TENSOR_LAT, STEP, STAGES, STAGE_KEYS = 512, 16, 2, 64
COUNTERS_PER_CELL = 32
KERNEL_MAX_SPLITS, MAX_SPLITS, MIN_SPLIT_STEPS = 64, 16, 2
# shared memory: the H100's per-SM 233,472 bytes, and a block's dynamic
# share (the 232,448-byte opt-in limit less the kernel's static arrays)
SM_SHARED, MAX_SHARED = 233472, 232448 - 2048


class MlaPlan(NamedTuple):
    path: int       # FIRST_DESIGN or TENSOR_CORES
    keys: int       # tensor cores: cache rows a stage (0 on the first design)
    splits: int     # the grid's splits of a (batch row, head group)
    min_steps: int  # tensor cores: 16-key steps a split takes at least
    chunk: int      # first design: cache rows a block (0 on tensor cores)


def choose_block(cache_len: int, preferred: int):
    """Largest tile that divides the cache buffer: ``preferred``, then
    256, then 128, or the whole buffer when it is no longer than
    ``preferred``; None when none divides (the port's copy of
    ``apex_tpu.kernels.registry.choose_block``)."""
    if cache_len <= preferred:
        return cache_len
    for b in (preferred, 256, 128):
        if b <= cache_len and cache_len % b == 0:
            return b
    return None


def use_flash(cache_len: int, block_t: int = DEFAULT_BLOCK_T) -> bool:
    """Whether the model's single-token step takes the kernel branch: a
    tile divides the cache buffer (JAX's condition with its kernel on)."""
    return choose_block(cache_len, block_t) is not None


def mla_decode_reference(q_full, cache, length, lat, scale):
    """Einsum version (JAX's oracle): q_full [b, n, L], cache [T, b, L],
    ``length`` live rows (a host int, or an integer tensor [b]: each
    row's own) -> ctx_lat [b, n, lat] fp32."""
    scores = torch.einsum("bnl,tbl->bnt", q_full.float(),
                          cache.float()) * scale
    n = _checks.plain_offsets(length, q_full.shape[0], q_full.device)
    t = torch.arange(cache.shape[0], device=q_full.device)
    scores = scores.masked_fill((t[None, :] >= n[:, None])[:, None, :],
                                NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnt,tbl->bnl", probs, cache[..., :lat].float())


def split_rows(T: int, b: int, n: int, sms: int):
    """The first design's (rows a block, blocks along the cache): the
    cache is cut so that b x head groups x splits fills two blocks an SM,
    in whole tiles."""
    groups = -(-n // HEADS_PER_BLOCK)
    want = max(1, (2 * sms) // (b * groups))
    chunk = -(-T // want)
    chunk = -(-chunk // ROWS_PER_TILE) * ROWS_PER_TILE
    return chunk, -(-T // chunk)


def shared_bytes(L: int) -> int:
    """The tensor-core body's dynamic shared memory (the source's
    ``mma_shared_bytes``): Q [16][L + 8], the ring [STAGES][STAGE_KEYS][L
    + 8] and three P planes [16][STAGE_KEYS + 8], bf16."""
    return 2 * ((16 + STAGES * STAGE_KEYS) * (L + 8)
                + 3 * 16 * (STAGE_KEYS + 8))


def mla_plan(b: int, n: int, L: int, lat: int, T: int, q_dtype, c_dtype,
             aligned: bool, sms: int) -> MlaPlan:
    """The body and sizes of one launch. bf16 q and cache on 16-byte
    boundaries with lat = TENSOR_LAT (DeepSeek's kv_lora_rank) and L a
    multiple of 64 take the tensor-core body: stages of STAGE_KEYS rows,
    and S splits a (batch row, head group) so that the blocks the card
    holds at once are filled (S = 1 when b x head groups already fill
    them), at most MAX_SPLITS; a live range then uses
    :func:`used_splits` of them. Every other case takes the first design,
    cut by :func:`split_rows`."""
    smem = shared_bytes(L)
    if (q_dtype == c_dtype == torch.bfloat16 and aligned and L % 64 == 0
            and lat == TENSOR_LAT <= L and smem <= MAX_SHARED):
        blocks = b * -(-n // HEADS_PER_BLOCK)
        resident = max(1, SM_SHARED // (smem + 1024)) * sms
        splits = 1 if blocks >= resident else min(MAX_SPLITS,
                                                  -(-resident // blocks))
        return MlaPlan(TENSOR_CORES, STAGE_KEYS, splits, MIN_SPLIT_STEPS, 0)
    chunk, splits = split_rows(T, b, n, sms)
    return MlaPlan(FIRST_DESIGN, 0, splits, 0, chunk)


def used_splits(length: int, splits: int, min_steps: int) -> int:
    """How many of the grid's ``splits`` a live range of ``length`` rows
    uses on the tensor-core body: one for every ``min_steps`` 16-key
    steps, at least one (the kernel's rule)."""
    steps = -(-length // STEP)
    return max(1, min(splits, steps // min_steps))


def split_keys(length: int, split: int, splits: int, min_steps: int):
    """Rows [lo, hi) that split ``split`` of the grid's ``splits`` reads
    on the tensor-core body: the range's ceil(length / 16) steps cut at s
    * steps // S' for the S' = :func:`used_splits` splits it uses (the
    rest are empty), so every live row lies in exactly one split."""
    used = used_splits(length, splits, min_steps)
    if split >= used:
        return 0, 0
    steps = -(-length // STEP)
    return (STEP * (steps * split // used),
            min(STEP * (steps * (split + 1) // used), length))


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "mla_decode", "apex_mla_decode",
        [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, i, p])


def _launch(q_full, cache, lengths, lat, scale, plan, path):
    """#26 through its C function on ``path`` with ``plan``'s sizes and the
    wrapper's scratch, unchecked and uncounted (:func:`mla_flash_decode`
    checks and counts; the card checks force paths and sizes here)."""
    b, n, L = q_full.shape
    T = cache.shape[0]
    dev = q_full.device
    f32 = torch.float32
    out = torch.empty((b, n, lat), dtype=f32, device=dev)
    acc = ml = counters = None
    if path == FIRST_DESIGN:
        acc = torch.empty((plan.splits, b, n, lat), dtype=f32, device=dev)
        ml = torch.empty((plan.splits, b, n, 2), dtype=f32, device=dev)
    elif plan.splits > 1:  # the merge tree's nodes: fewer than 2 S a cell
        cells = b * -(-n // HEADS_PER_BLOCK)
        rows = cells * 2 * plan.splits * HEADS_PER_BLOCK
        acc = torch.empty(rows * lat, dtype=f32, device=dev)
        ml = torch.empty(rows * 2, dtype=f32, device=dev)
        counters = kv_attention.counters(dev, cells * COUNTERS_PER_CELL)
    with torch.cuda.device(dev):
        rc = _kernel()(q_full.data_ptr(), cache.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(),
                       _checks.data_ptr(acc), _checks.data_ptr(ml),
                       _checks.data_ptr(counters), b, n, L, lat, T,
                       plan.chunk, plan.splits, plan.min_steps,
                       float(scale), _checks.DTYPE_CODES[q_full.dtype],
                       _checks.DTYPE_CODES[cache.dtype], path,
                       _checks.stream(q_full))
    _checks.status("mla_flash_decode", rc)
    return out


def plan_for(q_full, cache, lat) -> MlaPlan:
    """:func:`mla_plan` for these CUDA tensors (on their card's SMs)."""
    b, n, L = q_full.shape
    aligned = q_full.data_ptr() % 16 == 0 and cache.data_ptr() % 16 == 0
    return mla_plan(b, n, L, lat, cache.shape[0], q_full.dtype, cache.dtype,
                    aligned, kv_attention.sm_count(q_full.device.index or 0))


def mla_flash_decode(q_full, cache, length, lat, scale):
    """Streaming latent-cache decode attention for one step.

    q_full: [b, n, L] absorbed queries ``[q_lat | q_pe]``, fp32 or bf16.
    cache:  [T, b, L] latent rows (models/mla.py layout), fp32 or bf16.
    length: live prefix length INCLUDING the current token (>= 1): a
            host int for every row, or an integer tensor [b] on the
            device for each row (checked on the host: one sync).
    Returns ctx_lat [b, n, lat] fp32. A CPU tensor takes
    :func:`mla_decode_reference`; a CUDA tensor launches the kernel
    (L a multiple of 8 up to 1024, lat a multiple of 4 up to min(L, 512),
    any T; the body :func:`mla_plan` picks) or raises."""
    name = "mla_flash_decode"
    # a row with no live row has no softmax: the plain version would
    # average every row of the buffer, the kernel (as JAX's) gives 0
    if (bool((length < 1).any()) if isinstance(length, torch.Tensor)
            else length < 1):
        raise ValueError(f"{name}: every length must be >= 1, got {length}")
    if not _checks.on_cuda(name, q_full, cache):
        return mla_decode_reference(q_full, cache, length, lat, scale)
    if q_full.dim() != 3 or cache.dim() != 3:
        raise ValueError(f"{name}: q_full must be [b, n, L] and cache "
                         f"[T, b, L], got {tuple(q_full.shape)} and "
                         f"{tuple(cache.shape)}")
    b, n, L = q_full.shape
    T = cache.shape[0]
    if tuple(cache.shape[1:]) != (b, L) or T < 1 or b < 1 or n < 1:
        raise ValueError(f"{name}: cache {tuple(cache.shape)} does not "
                         f"match q_full {tuple(q_full.shape)}")
    if L % 8 or lat % 4 or L > MAX_L or not 0 < lat <= min(L, MAX_LAT):
        raise ValueError(f"{name}: L ({L}) must be a multiple of 8 and at "
                         f"most {MAX_L}, lat ({lat}) a multiple of 4 with 0 "
                         f"< lat <= min(L, {MAX_LAT})")
    if not math.isfinite(scale):
        raise ValueError(f"{name}: scale ({scale}) must be finite")
    _checks.contiguous(name, q_full=q_full, cache=cache)
    if q_full.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError(f"{name}: q_full and cache must start on 16-byte "
                         f"boundaries (the kernel's vector loads)")
    _checks.dtype_code(name, q_full, "q_full")
    _checks.dtype_code(name, cache, "cache")
    lengths = _checks.row_offsets(name, length, b, q_full.device, "length")
    plan = plan_for(q_full, cache, lat)
    out = _launch(q_full, cache, lengths, lat, scale, plan, plan.path)
    registry.count(MLA_DECODE, flops=4.0 * q_full.shape[0] * q_full.shape[1]
                   * cache.shape[0] * q_full.shape[-1],
                   bytes=registry.nbytes(q_full, cache, out))
    return out
