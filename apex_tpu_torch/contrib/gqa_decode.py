"""One-token GQA decode attention over the KV cache: the CUDA kernel
(csrc/gqa_decode.cu) and its plain PyTorch version.

Counterpart of ``apex_tpu/contrib/gqa_decode.py``: all ``rep`` query
heads of a kv group share each streamed K/V tile, tiles past the live
length (and, with a sliding window, before ``length - window``) are
never read, and a tanh softcap is applied to the scores.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

NEG_INF = -1e30
GQA_DECODE = registry.register("gqa_decode")


def gqa_decode_plain(q, k, v, length: int, sm_scale: float, window=None,
                     softcap=None):
    """Einsum version: q [b, g, rep, d], k/v [T, b, g, d], ``length`` live
    rows -> ctx [b, g, rep, d] fp32."""
    s = torch.einsum("bgrd,tbgd->bgrt", q.float(), k.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    t = torch.arange(k.shape[0], device=q.device)
    masked = t >= length
    if window is not None:
        masked = masked | (t < length - window)
    s = s.masked_fill(masked, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrt,tbgd->bgrd", p, v.float())


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "gqa_decode", "apex_gqa_decode",
        [p, p, p, p, i, i, i, i, i, i, i, f, f, i, p])


def gqa_flash_decode(q, k, v, length: int, sm_scale: float, window=None,
                     softcap=None):
    """Streaming KV-cache decode attention for one token step.

    q:      [b, g, rep, d] grouped queries (fp32 or bf16).
    k, v:   [T, b, g, d] cache buffers of q's dtype.
    length: live prefix length including the current token (a host int).
    window: optional sliding window (Mistral semantics).
    softcap: optional Gemma-2 tanh score cap.
    Returns ctx [b, g, rep, d] fp32. A CPU tensor takes
    :func:`gqa_decode_plain`; a CUDA tensor launches the kernel (head dim
    64 or 128, any T) or raises."""
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
    if not 1 <= length <= T:
        raise ValueError(f"gqa_flash_decode: length ({length}) must be in "
                         f"[1, {T}]")
    if window is not None and window < 1:
        raise ValueError(f"gqa_flash_decode: window ({window}) must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"gqa_flash_decode: softcap ({softcap}) must be > 0")
    _checks.contiguous("gqa_flash_decode", q=q, k=k, v=v)
    code = _checks.dtype_code("gqa_flash_decode", q, "q")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, g, rep, d, T, int(length),
                       window or 0, float(sm_scale), float(softcap or 0.0),
                       code, _checks.stream(q))
    _checks.status("gqa_flash_decode", rc)
    registry.count(GQA_DECODE)
    return out
