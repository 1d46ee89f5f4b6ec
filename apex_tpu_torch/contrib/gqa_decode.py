"""One-token GQA decode attention over the KV cache: the CUDA kernel
(csrc/gqa_decode.cu) and its plain PyTorch version.

Counterpart of ``apex_tpu/contrib/gqa_decode.py``: all ``rep`` query
heads of a kv group share each streamed K/V tile, tiles past the live
length (and, with a sliding window, before ``length - window``) are
never read, and a tanh softcap is applied to the scores. Each batch row
may have its own live length (the JAX kernel runs once per serving slot
under ``vmap``; here one launch takes every slot's length).
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import (
    _build,
    _checks,
    kv_attention,
    registry,
)

NEG_INF = -1e30
GQA_DECODE = registry.register("gqa_decode")


def gqa_decode_plain(q, k, v, length, sm_scale: float, window=None,
                     softcap=None):
    """Einsum version: q [b, g, rep, d], k/v [T, b, g, d], ``length`` live
    rows (a host int, or a [b] tensor: each row's own) -> ctx
    [b, g, rep, d] fp32."""
    s = torch.einsum("bgrd,tbgd->bgrt", q.float(), k.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    n = _checks.plain_offsets(length, q.shape[0], q.device)[:, None]
    t = torch.arange(k.shape[0], device=q.device)[None, :]
    masked = t >= n  # [b, T]
    if window is not None:
        masked = masked | (t < n - window)
    s = s.masked_fill(masked[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrt,tbgd->bgrd", p, v.float())


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "gqa_decode", "apex_gqa_decode",
        [p, p, p, p, i, i, i, i, i, p, i, f, f, i, i, p, p, p])


def gqa_flash_decode(q, k, v, length, sm_scale: float, window=None,
                     softcap=None):
    """Streaming KV-cache decode attention for one token step.

    q:      [b, g, rep, d] grouped queries (fp32 or bf16).
    k, v:   [T, b, g, d] cache buffers of q's dtype.
    length: live prefix length including the current token: a host int
            for every row, or an integer tensor [b] (on the device) for
            each row, as the serving engine's slots need.
    window: optional sliding window (Mistral semantics).
    softcap: optional Gemma-2 tanh score cap.
    Returns ctx [b, g, rep, d] fp32. A CPU tensor takes
    :func:`gqa_decode_plain`; a CUDA tensor launches the kernel (head dim
    64 or 128, any T, tensors on 16-byte boundaries) or raises: one
    launch, the live range split over the SMs (``kv_attention.plan``)."""
    if not _checks.on_cuda("gqa_flash_decode", q, k, v):
        return gqa_decode_plain(q, k, v, length, sm_scale, window, softcap)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("gqa_flash_decode: q must be [b, g, rep, d] and k/v "
                         "[T, b, g, d]")
    b, g, rep, d = q.shape
    T = k.shape[0]
    if tuple(k.shape) != (T, b, g, d) or v.shape != k.shape:
        raise ValueError(f"gqa_flash_decode: cache {tuple(k.shape)} / "
                         f"{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("gqa_flash_decode: q, k and v must share a dtype")
    if not isinstance(length, torch.Tensor) and not 1 <= length <= T:
        raise ValueError(f"gqa_flash_decode: length ({length}) must be in "
                         f"[1, {T}]")
    if window is not None and window < 1:
        raise ValueError(f"gqa_flash_decode: window ({window}) must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"gqa_flash_decode: softcap ({softcap}) must be > 0")
    _checks.contiguous("gqa_flash_decode", q=q, k=k, v=v)
    _checks.aligned16("gqa_flash_decode", q=q, k=k, v=v)
    code = _checks.dtype_code("gqa_flash_decode", q, "q")
    lengths = _checks.row_offsets("gqa_flash_decode", length, b, q.device,
                                  "length")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        splits, scratch, counters = kv_attention.workspace(
            q.device, rep, b * g, d)
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, g, rep, d, T, lengths.data_ptr(),
                       window or 0, float(sm_scale), float(softcap or 0.0),
                       code, splits, _checks.data_ptr(scratch),
                       _checks.data_ptr(counters), _checks.stream(q))
    _checks.status("gqa_flash_decode", rc)
    registry.count(GQA_DECODE, flops=4.0 * b * g * rep * d * T,
                   bytes=registry.nbytes(q, k, v, out))
    return out
