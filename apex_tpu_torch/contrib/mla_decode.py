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
"""

import ctypes
import functools
import math

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

NEG_INF = -1e30
DEFAULT_BLOCK_T = 512
MLA_DECODE = registry.register("mla_decode")

# the kernel's block shape (csrc/mla_decode.cu): a group of 16 heads, 16
# cache rows a tile, at most 512 latent columns, rows of at most 1024
# (at most 202 KB of shared memory a block)
HEADS_PER_BLOCK, ROWS_PER_TILE, MAX_LAT, MAX_L = 16, 16, 512, 1024


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


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_rows(T: int, b: int, n: int, sms: int):
    """(rows a block, blocks along the cache): the cache is cut so that
    b x head groups x splits fills two blocks an SM, in whole tiles."""
    groups = -(-n // HEADS_PER_BLOCK)
    want = max(1, (2 * sms) // (b * groups))
    chunk = -(-T // want)
    chunk = -(-chunk // ROWS_PER_TILE) * ROWS_PER_TILE
    return chunk, -(-T // chunk)


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "mla_decode", "apex_mla_decode",
        [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, p])


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
    any T) or raises."""
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
    q_code = _checks.dtype_code(name, q_full, "q_full")
    c_code = _checks.dtype_code(name, cache, "cache")
    lengths = _checks.row_offsets(name, length, b, q_full.device, "length")
    chunk, splits = split_rows(T, b, n, _sm_count(q_full.device.index or 0))
    out = torch.empty((b, n, lat), dtype=torch.float32, device=q_full.device)
    acc = torch.empty((splits, b, n, lat), dtype=torch.float32,
                      device=q_full.device)
    ml = torch.empty((splits, b, n, 2), dtype=torch.float32,
                     device=q_full.device)
    with torch.cuda.device(q_full.device):
        rc = _kernel()(q_full.data_ptr(), cache.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), acc.data_ptr(),
                       ml.data_ptr(), b, n, L, lat, T, chunk, splits,
                       float(scale), q_code, c_code, _checks.stream(q_full))
    _checks.status(name, rc)
    registry.count(MLA_DECODE)
    return out
