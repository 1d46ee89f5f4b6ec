"""Window attention over the KV cache and speculative-verify attention
over the int8 cache: the CUDA kernels (csrc/window_attention.cu,
csrc/spec_verify.cu) and their plain PyTorch versions.

Counterpart of ``apex_tpu/kernels/fused_cc.py`` family (b):
``window_attention`` (the prefill and verify window) and
``spec_verify_attention`` (the verify window read straight from the int8
blockwise serving store). Each batch row may sit at its own offset: the
serving engine's slots are at different fill levels (the JAX functions
take one scalar start and run under ``vmap`` over slots). The fused int4
kernels of family (c) are in :mod:`apex_tpu_torch.kernels.quant4`, beside
the unfused ones they fuse; the GEMM of family (a) is still to be ported.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, quant, registry

NEG_INF = -1e30
WINDOW_ATTENTION = registry.register("window_attention")
SPEC_VERIFY = registry.register("spec_verify")


def window_attention_plain(qg, kt, vt, start, sm_scale, window=None,
                           softcap=None):
    """Einsum version: qg [w, b, g, rep, d] queries at absolute positions
    ``start + i`` (``start`` a host int or a [b] tensor, one offset per
    row), kt/vt [T, b, g, d] cache buffers (window rows already written)
    -> ctx [w, b, g, rep, d] fp32. Mask: causal at each query's own
    position, plus the optional sliding window."""
    s = torch.einsum("sbgrd,tbgd->bgrst", qg.float(), kt.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    w, b = qg.shape[:2]
    st = _checks.plain_offsets(start, b, qg.device)
    ipos = (st[:, None] + torch.arange(w, device=qg.device))[:, :, None]
    jpos = torch.arange(kt.shape[0], device=qg.device)[None, None, :]
    masked = jpos > ipos  # [b, w, T]
    if window is not None:
        masked = masked | (ipos - jpos >= window)
    s = s.masked_fill(masked[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrst,tbgd->sbgrd", p, vt.float())


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "window_attention", "apex_window_attention",
        [p, p, p, p, i, i, i, i, i, i, p, i, f, f, i, p])


def window_attention(qg, kt, vt, start, sm_scale: float, window=None,
                     softcap=None):
    """Flash attention for a w-position chunk over the KV cache.

    qg:     [w, b, g, rep, d] grouped queries at positions start ..
            start + w - 1 (fp32 or bf16).
    kt, vt: [T, b, g, d] cache buffers of qg's dtype, with the chunk's
            rows written.
    start:  absolute position of the first query: a host int for every
            row, or an integer tensor [b] (on the device) for each row.
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
    if not isinstance(start, torch.Tensor) and (start < 0
                                                or start + w > T):
        raise ValueError(f"window_attention: positions [{start}, "
                         f"{start + w}) do not fit the cache of {T}")
    if window is not None and window < 1:
        raise ValueError(f"window_attention: window ({window}) must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"window_attention: softcap ({softcap}) must be > 0")
    _checks.contiguous("window_attention", qg=qg, kt=kt, vt=vt)
    code = _checks.dtype_code("window_attention", qg, "qg")
    starts = _checks.row_offsets("window_attention", start, b, qg.device,
                                 "start")
    out = torch.empty(qg.shape, dtype=torch.float32, device=qg.device)
    with torch.cuda.device(qg.device):
        rc = _kernel()(qg.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                       out.data_ptr(), w, b, g, rep, d, T, starts.data_ptr(),
                       window or 0, float(sm_scale), float(softcap or 0.0),
                       code, _checks.stream(qg))
    _checks.status("window_attention", rc)
    registry.count(WINDOW_ATTENTION)
    return out


def _batched(q, kq, ks, vq, vs):
    """The JAX function's one-slot layout ([w, g, rep, d] and [T, nb, *])
    as a batch of one; a batched call passes through."""
    if q.dim() == 4:
        return q[:, None], kq[:, None], ks[:, None], vq[:, None], vs[:, None]
    return q, kq, ks, vq, vs


def spec_verify_reference(q, kq, ks, vq, vs, start, sm_scale):
    """Plain version, the JAX package's unfused oracle: dequantize the
    blockwise cache into full fp32 K/V (the serving store's
    ``materialize_rows``) and run :func:`window_attention_plain` over it.
    Shapes as :func:`spec_verify_attention`."""
    one = q.dim() == 4
    q, kq, ks, vq, vs = _batched(q, kq, ks, vq, vs)
    w, b, g, rep, d = q.shape
    T, _, nb, B = kq.shape

    def dense(codes, scales):
        return quant.dequantize_rows_plain(
            codes.reshape(T * b, nb, B), scales.reshape(T * b, nb, 1),
            g * d).reshape(T, b, g, d)

    ctx = window_attention_plain(q, dense(kq, ks), dense(vq, vs), start,
                                 sm_scale)
    return ctx[:, 0] if one else ctx


@functools.lru_cache(maxsize=1)
def _verify_kernel():
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    return _build.function(
        "spec_verify", "apex_spec_verify",
        [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, f, i, p])


def spec_verify_attention(q, kq, ks, vq, vs, start, sm_scale: float):
    """Verify-window attention read straight from the int8 blockwise KV
    cache: the quantized blocks are widened and scaled in the kernel
    (``kq * ks`` per block), so no dequantized cache is written.

    q:      [w, g, rep, d] (one slot, the JAX signature) or
            [w, b, g, rep, d] (a batch of slots), fp32 or bf16, at
            positions start .. start + w - 1.
    kq, vq: int8 codes [T, nb, B] (or [T, b, nb, B]), with g * d <= nb * B:
            trailing lanes are quantization padding.
    ks, vs: fp32 block scales [T, nb, 1] (or [T, b, nb, 1]).
    start:  a host int, or an integer tensor [b] with each slot's offset.
    Returns ctx of q's shape, fp32; causal at each query's position. A
    CPU tensor takes :func:`spec_verify_reference`; a CUDA tensor
    launches the kernel (head dim 64 or 128) or raises."""
    name = "spec_verify_attention"
    if not _checks.on_cuda(name, q, kq, ks, vq, vs):
        return spec_verify_reference(q, kq, ks, vq, vs, start, sm_scale)
    if q.dim() not in (4, 5) or kq.dim() != q.dim() - 1:
        raise ValueError(f"{name}: q must be [w, g, rep, d] with kq/vq "
                         f"[T, nb, B], or [w, b, g, rep, d] with "
                         f"[T, b, nb, B]; got {tuple(q.shape)} and "
                         f"{tuple(kq.shape)}")
    one = q.dim() == 4
    q5, kq4, ks4, vq4, vs4 = _batched(q, kq, ks, vq, vs)
    w, b, g, rep, d = q5.shape
    T, _, nb, B = kq4.shape
    if tuple(kq4.shape) != (T, b, nb, B) or vq4.shape != kq4.shape:
        raise ValueError(f"{name}: codes {tuple(kq.shape)} / "
                         f"{tuple(vq.shape)} do not match q {tuple(q.shape)}")
    if tuple(ks4.shape) != (T, b, nb, 1) or vs4.shape != ks4.shape:
        raise ValueError(f"{name}: scales {tuple(ks.shape)} / "
                         f"{tuple(vs.shape)} must be [T, (b,) nb, 1]")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError(f"{name}: kq and vq must be int8")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"{name}: ks and vs must be float32")
    if g * d > nb * B:
        raise ValueError(f"{name}: g * d ({g * d}) exceeds the cache row's "
                         f"nb * B ({nb * B}) lanes")
    if not isinstance(start, torch.Tensor) and (start < 0
                                                or start + w > T):
        raise ValueError(f"{name}: positions [{start}, {start + w}) do not "
                         f"fit the cache of {T}")
    _checks.contiguous(name, q=q, kq=kq, ks=ks, vq=vq, vs=vs)
    code = _checks.dtype_code(name, q, "q")
    starts = _checks.row_offsets(name, start, b, q.device, "start")
    out = torch.empty(q5.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _verify_kernel()(
            q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), out.data_ptr(), w, b, g, rep, d, T, nb, B,
            starts.data_ptr(), float(sm_scale), code, _checks.stream(q))
    _checks.status(name, rc)
    registry.count(SPEC_VERIFY)
    return out[:, 0] if one else out
