"""Prefill-window attention over the KV cache: the CUDA kernel
(csrc/window_attention.cu) and its plain PyTorch version.

Counterpart of ``apex_tpu/kernels/fused_cc.py`` ``window_attention``
(family b). The GEMM, int4 and int8-verify kernels of that module are
still to be ported.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

NEG_INF = -1e30
WINDOW_ATTENTION = registry.register("window_attention")


def window_attention_plain(qg, kt, vt, start, sm_scale, window=None,
                           softcap=None):
    """Einsum version: qg [w, b, g, rep, d] queries at absolute positions
    ``start + i``, kt/vt [T, b, g, d] cache buffers (window rows already
    written) -> ctx [w, b, g, rep, d] fp32. Mask: causal at each query's
    own position, plus the optional sliding window."""
    s = torch.einsum("sbgrd,tbgd->bgrst", qg.float(), kt.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    w = qg.shape[0]
    ipos = start + torch.arange(w, device=qg.device)[:, None]
    jpos = torch.arange(kt.shape[0], device=qg.device)[None, :]
    masked = jpos > ipos
    if window is not None:
        masked = masked | (ipos - jpos >= window)
    s = s.masked_fill(masked, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrst,tbgd->sbgrd", p, vt.float())


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "window_attention", "apex_window_attention",
        [p, p, p, p, i, i, i, i, i, i, i, i, f, f, i, p])


def window_attention(qg, kt, vt, start: int, sm_scale: float, window=None,
                     softcap=None):
    """Flash attention for a w-position chunk over the KV cache.

    qg:     [w, b, g, rep, d] grouped queries at positions start ..
            start + w - 1 (fp32 or bf16).
    kt, vt: [T, b, g, d] cache buffers of qg's dtype, with the chunk's
            rows written.
    start:  absolute position of the first query (a host int).
    Returns ctx [w, b, g, rep, d] fp32. A CPU tensor takes
    :func:`window_attention_plain`; a CUDA tensor launches the kernel
    (head dim 64 or 128, any T) or raises."""
    if not _checks.on_cuda("window_attention", qg, kt, vt):
        return window_attention_plain(qg, kt, vt, start, sm_scale, window,
                                      softcap)
    if qg.dim() != 5 or kt.dim() != 4:
        raise ValueError("window_attention: qg must be [w, b, g, rep, d] and "
                         "kt/vt [T, b, g, d]")
    w, b, g, rep, d = qg.shape
    T = kt.shape[0]
    if tuple(kt.shape) != (T, b, g, d) or vt.shape != kt.shape:
        raise ValueError(f"window_attention: cache {tuple(kt.shape)} / "
                         f"{tuple(vt.shape)} does not match qg "
                         f"{tuple(qg.shape)}")
    if kt.dtype != qg.dtype or vt.dtype != qg.dtype:
        raise TypeError("window_attention: qg, kt and vt must share a dtype")
    if start < 0 or start + w > T:
        raise ValueError(f"window_attention: positions [{start}, "
                         f"{start + w}) do not fit the cache of {T}")
    if window is not None and window < 1:
        raise ValueError(f"window_attention: window ({window}) must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"window_attention: softcap ({softcap}) must be > 0")
    _checks.contiguous("window_attention", qg=qg, kt=kt, vt=vt)
    code = _checks.dtype_code("window_attention", qg, "qg")
    out = torch.empty(qg.shape, dtype=torch.float32, device=qg.device)
    with torch.cuda.device(qg.device):
        rc = _kernel()(qg.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                       out.data_ptr(), w, b, g, rep, d, T, int(start),
                       window or 0, float(sm_scale), float(softcap or 0.0),
                       code, _checks.stream(qg))
    _checks.status("window_attention", rc)
    registry.count(WINDOW_ATTENTION)
    return out
