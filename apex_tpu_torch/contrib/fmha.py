"""Flash attention: the CUDA kernels (csrc/flash_attention.cu), their
plain PyTorch versions, and the differentiable ``flash_attention``.

Counterpart of ``apex_tpu/contrib/fmha.py``: attention over
``[batch, heads, seq, head_dim]`` inputs, causal or full, with an
optional sliding-window band (key j visible to query i iff
``0 <= i - j < window``) and optional per-head ALiBi slopes (the
key-position bias ``slope[h] * j``). The forward keeps fp32 running
statistics and emits the per-row log-sum-exp; the backward recomputes
``p = exp(q k^T scale - lse)`` tile by tile (flash-attention v2), so
neither pass stores an ``[s, s]`` matrix. The autograd Function saves
q, k, v, o and lse only.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor
it launches the kernels (fp32 or bf16, head dim 64, 128 or 256, any
sequence length) or raises.
"""

import ctypes
import functools
import numbers

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30  # not the -10000 of the softmax kernels
HEAD_DIMS = (64, 128, 256)
FLASH_FWD = registry.register("flash_fwd")
FLASH_DQ = registry.register("flash_dq")
FLASH_DKV = registry.register("flash_dkv")


def _visible(sq, sk, causal, window, device):
    """[sq, sk] bool: key j visible to query i (the last query sees the
    last key when sq != sk)."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    live = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)
    if window is not None:
        live &= torch.ones(sq, sk, dtype=torch.bool,
                           device=device).triu(sk - sq - window + 1)
    return live


def _alibi(alibi_slopes, sk, device):
    """[1, n, 1, sk] key-position bias slope[h] * j in fp32."""
    j = torch.arange(sk, dtype=torch.float32, device=device)
    return alibi_slopes.float()[None, :, None, None] * j


def _scores(q, k, scale, causal, window, alibi_slopes, scale_first):
    """fp32 masked scores: (q * scale) k^T as the forward kernel orders
    it (``scale_first``), or (q k^T) * scale as the backward's."""
    qf, kf = q.float(), k.float()
    if scale_first:
        s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    else:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if alibi_slopes is not None:
        s = s + _alibi(alibi_slopes, s.shape[-1], s.device)
    live = _visible(s.shape[-2], s.shape[-1], causal, window, s.device)
    return s.masked_fill(~live, NEG_INF)


def attention_reference(q, k, v, scale, causal, window=None,
                        alibi_slopes=None):
    """Einsum attention with an fp32 softmax, in q's dtype (JAX's
    ``_attention_reference``). k/v may be longer than q: the last query
    then sees the last key."""
    s = _scores(q, k, scale, causal, window, alibi_slopes, scale_first=False)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_fwd_plain(q, k, v, scale, causal, window=None, alibi_slopes=None):
    """The forward kernel's function: q, k, v [b, n, s, d] -> (o in q's
    dtype, lse [b, n, s] fp32), with max(l, 1e-30) as the kernel clamps
    the row sum."""
    s = _scores(q, k, scale, causal, window, alibi_slopes, scale_first=True)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(e, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _delta(o, do):
    """delta = rowsum(do * o) in fp32, over the saved (rounded) o."""
    return torch.sum(do.float() * o.float(), dim=-1)


def _probs(q, k, lse, scale, causal, window, alibi_slopes):
    s = _scores(q, k, scale, causal, window, alibi_slopes, scale_first=False)
    return torch.exp(s - lse[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, scale, causal, window=None,
                   alibi_slopes=None):
    """The dq kernel's function: p = exp(q k^T scale - lse), ds = p (do
    v^T - delta), dq = (ds k) scale, in q's dtype."""
    p = _probs(q, k, lse, scale, causal, window, alibi_slopes)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2))
              - delta[..., None])
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, scale, causal, window=None,
                    alibi_slopes=None):
    """The dk/dv kernel's function: dv = p^T do, dk = (ds^T q) scale, in
    q's dtype."""
    p = _probs(q, k, lse, scale, causal, window, alibi_slopes)
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2))
              - delta[..., None])
    del p
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, scale, causal, window=None,
                    alibi_slopes=None):
    """The backward's function: (dq, dk, dv) in q's dtype from the saved
    o and lse. Its ``[s, s]`` intermediates live for one call only."""
    delta = _delta(o, do)
    dq = flash_dq_plain(q, k, v, do, lse, delta, scale, causal, window,
                        alibi_slopes)
    return (dq, *flash_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                                 window, alibi_slopes))


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    outs = {"apex_flash_fwd": 2, "apex_flash_dq": 1, "apex_flash_dkv": 2}
    ins = 3 if symbol == "apex_flash_fwd" else 6
    return _build.function("flash_attention", symbol,
                           [p] * (ins + 1 + outs[symbol])
                           + [i, i, i, i, f, i, i, i, p])


def _check_kernel_args(name, q, k, v, window, alibi_slopes, do=None):
    """Shapes, dtypes and layout the kernels take; returns the dtype code
    and the slopes as a contiguous fp32 tensor or None."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must be one [b, n, s, d] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, n, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if b * n >= 2 ** 31 or s > 65535 * 32:
        raise ValueError(f"{name}: {b * n} heads of {s} rows exceed one "
                         f"launch's grid")
    more = {} if do is None else {"do": do}
    if any(t.dtype != q.dtype for t in (k, v, *more.values())):
        raise TypeError(f"{name}: q, k, v (and do) must share a dtype")
    code = _checks.dtype_code(name, q, "q")
    _checks.contiguous(name, q=q, k=k, v=v, **more)
    if window is not None and window < 1:
        raise ValueError(f"{name}: window ({window}) must be >= 1")
    if alibi_slopes is None:
        return code, None
    if alibi_slopes.shape != (n,):
        raise ValueError(f"{name}: alibi_slopes must be [{n}], got "
                         f"{tuple(alibi_slopes.shape)}")
    return code, alibi_slopes.float().contiguous()


def _common(q, scale, causal, window, slopes, code):
    """The C functions' trailing arguments, and the slopes' pointer. A
    window of s or more masks nothing more than causality and goes to the
    kernel as s (a C int)."""
    b, n, s, d = q.shape
    window = 0 if window is None else min(int(window), s)
    return [b * n, n, s, d, float(scale), int(bool(causal)), window,
            code, _checks.stream(q)], (0 if slopes is None
                                       else slopes.data_ptr())


def flash_fwd(q, k, v, scale, causal, window=None, alibi_slopes=None):
    """Forward: q, k, v [b, n, s, d] -> (o [b, n, s, d] in q's dtype, lse
    [b, n, s] fp32). A CPU tensor takes :func:`flash_fwd_plain`; a CUDA
    tensor launches the kernel or raises."""
    extra = () if alibi_slopes is None else (alibi_slopes,)
    if not _checks.on_cuda("flash_fwd", q, k, v, *extra):
        return flash_fwd_plain(q, k, v, scale, causal, window, alibi_slopes)
    code, slopes = _check_kernel_args("flash_fwd", q, k, v, window,
                                      alibi_slopes)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    tail, slopes_ptr = _common(q, scale, causal, window, slopes, code)
    with torch.cuda.device(q.device):
        rc = _kernel("apex_flash_fwd")(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), slopes_ptr, o.data_ptr(),
                                       lse.data_ptr(), *tail)
    _checks.status("flash_fwd", rc)
    registry.count(FLASH_FWD)
    return o, lse


def _check_bwd_args(name, q, k, v, do, lse, delta, window,
                    alibi_slopes):
    code, slopes = _check_kernel_args(name, q, k, v, window, alibi_slopes,
                                      do)
    for what, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:-1] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be fp32 "
                             f"{tuple(q.shape[:-1])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _checks.contiguous(name, lse=lse, delta=delta)
    return code, slopes


def flash_dq(q, k, v, do, lse, delta, scale, causal, window=None,
             alibi_slopes=None):
    """dq in q's dtype from the output gradient do, lse and delta [b, n,
    s] fp32. A CPU tensor takes :func:`flash_dq_plain`; a CUDA tensor
    launches the kernel or raises."""
    extra = () if alibi_slopes is None else (alibi_slopes,)
    if not _checks.on_cuda("flash_dq", q, k, v, do, lse, delta, *extra):
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal, window,
                              alibi_slopes)
    code, slopes = _check_bwd_args("flash_dq", q, k, v, do, lse, delta,
                                   window, alibi_slopes)
    dq = torch.empty_like(q)
    tail, slopes_ptr = _common(q, scale, causal, window, slopes, code)
    with torch.cuda.device(q.device):
        rc = _kernel("apex_flash_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), slopes_ptr, dq.data_ptr(),
            *tail)
    _checks.status("flash_dq", rc)
    registry.count(FLASH_DQ)
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale, causal, window=None,
              alibi_slopes=None):
    """(dk, dv) in q's dtype, from the same inputs as :func:`flash_dq`. A
    CPU tensor takes :func:`flash_dkv_plain`; a CUDA tensor launches the
    kernel or raises."""
    extra = () if alibi_slopes is None else (alibi_slopes,)
    if not _checks.on_cuda("flash_dkv", q, k, v, do, lse, delta, *extra):
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                               window, alibi_slopes)
    code, slopes = _check_bwd_args("flash_dkv", q, k, v, do, lse, delta,
                                   window, alibi_slopes)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    tail, slopes_ptr = _common(q, scale, causal, window, slopes, code)
    with torch.cuda.device(q.device):
        rc = _kernel("apex_flash_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), slopes_ptr, dk.data_ptr(),
            dv.data_ptr(), *tail)
    _checks.status("flash_dkv", rc)
    registry.count(FLASH_DKV)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, scale, causal, window=None,
              alibi_slopes=None):
    """Backward: (dq, dk, dv) in q's dtype from the saved o and lse [b, n,
    s] and the output gradient do: delta = rowsum(do * o) over the saved
    o (one PyTorch expression, as in JAX), then :func:`flash_dq` and
    :func:`flash_dkv`, each of which launches its kernel on CUDA tensors
    and takes its plain version on CPU ones."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_bwd: o must match q, got {o.dtype} "
                         f"{tuple(o.shape)}")
    delta = _delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, scale, causal, window,
                  alibi_slopes)
    return (dq, *flash_dkv(q, k, v, do, lse, delta, scale, causal, window,
                           alibi_slopes))


def _resolve(q, scale, block_q, block_k):
    """The scale (JAX's rules) after checking the TPU tile arguments."""
    for name, block in (("block_q", block_q), ("block_k", block_k)):
        if (isinstance(block, bool) or not isinstance(block, numbers.Integral)
                or block < 1):
            raise ValueError(f"flash_attention {name} must be a positive "
                             f"int, got {block!r}")
    if scale is None:
        return 1.0 / (q.shape[-1] ** 0.5)
    if not isinstance(scale, numbers.Number):
        raise TypeError(
            "flash_attention scale must be a python number, got "
            f"{type(scale)}; pass scale=None for the 1/sqrt(head_dim) "
            "default")
    return float(scale)


def _check_window(window, causal):
    if window is None:
        return
    if not causal:
        raise ValueError("flash_attention window requires causal=True")
    # numbers.Integral admits numpy scalars from parsed configs; bool is
    # an int subclass and must not silently mean window=1.
    if (isinstance(window, bool) or not isinstance(window, numbers.Integral)
            or window < 1):
        raise ValueError(f"flash_attention window must be a positive "
                         f"int, got {window!r}")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, alibi_slopes, causal, scale, window):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = flash_fwd(q, k, v, scale, causal, window, alibi_slopes)
        ctx.save_for_backward(q, k, v, o, lse, alibi_slopes)
        ctx.args = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, alibi_slopes = ctx.saved_tensors
        scale, causal, window = ctx.args
        dq, dk, dv = flash_bwd(q, k, v, o, lse,
                               do.to(o.dtype).contiguous(), scale, causal,
                               window, alibi_slopes)
        slope_grad = (None if alibi_slopes is None
                      else torch.zeros_like(alibi_slopes))
        return dq, dk, dv, slope_grad, None, None, None


def flash_attention(q, k, v, causal=True, scale=None,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    window=None, alibi_slopes=None):
    """Flash attention over [batch, heads, seq, head_dim] inputs, in q's
    dtype and differentiable in q, k and v.

    ``scale``: a python number, default 1/sqrt(head_dim). ``window``:
    sliding-window band (causal only), tiles fully outside it skipped.
    ``alibi_slopes``: per-head [heads] slopes of the key-position bias;
    not differentiable (their gradient is zero, as in JAX and the CUDA
    flash-attention convention). ``block_q`` and ``block_k`` are the JAX
    package's TPU tiles; they are checked and otherwise unused: the CUDA
    kernels pick their own tiles (64 rows for head dims 64 and 128, 32
    for 256) and take any sequence length, so nothing here falls back to
    the einsum reference. The function saves q, k, v, o and lse for the
    backward, never an [s, s] matrix."""
    _check_window(window, causal)
    scale = _resolve(q, scale, block_q, block_k)
    window = None if window is None else int(window)
    return _FlashAttention.apply(q, k, v, alibi_slopes, bool(causal), scale,
                                 window)


class FMHA:
    """Class-style entry point (JAX's ``FMHA``, after apex's FMHAFun):
    ``qkv`` [b, s, 3, n, d] -> [b, s, n, d]. The reference fused kernel
    took seq in {128, 256, 384, 512} and d = 64; the kernels here are
    general, and the same list is exposed."""

    supported_seq_lens = (128, 256, 384, 512)

    def __init__(self, causal=False):
        self.causal = causal

    def __call__(self, qkv, cu_seqlens=None, seqlen=None):
        q, k, v = (qkv[..., i, :, :].transpose(1, 2) for i in range(3))
        return flash_attention(q, k, v, self.causal).transpose(1, 2)
