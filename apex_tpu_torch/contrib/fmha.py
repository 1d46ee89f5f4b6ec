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
sequence length) or raises. The forward's body comes from
:func:`fwd_plan` and the backward's from :func:`bwd_plan`: tensor-core
bodies for head dims 64 and 128 (fp32 products as three TF32 terms; the
bf16 forward on bf16 tensor cores with p as three bf16 terms), the first
design (fp32 FMAs) for 256 and for operands off a 16-byte boundary.
"""

import ctypes
import functools
import numbers
from typing import NamedTuple

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30  # not the -10000 of the softmax kernels
HEAD_DIMS = (64, 128, 256)
FLASH_FWD = registry.register("flash_fwd")
FLASH_DQ = registry.register("flash_dq")
FLASH_DKV = registry.register("flash_dkv")
# The kernels' bodies, as csrc/flash_attention.cu numbers them (the `path`
# of apex_flash_fwd, apex_flash_dq and apex_flash_dkv): the first design,
# one 256-thread block of fp32 FMAs per 64 rows (32 at head dim 256); the
# tensor-core bodies, a block of warps of 16 rows streaming the other
# operand in tiles through cp.async stages (BWD_STAGES for the backward).
# (The C functions also take two codes of planted faults, which the
# package never passes.)
PATH_SIMT, PATH_MMA = 0, 1
BWD_SIMT_THREADS, BWD_STAGES = 256, 2


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


class BwdPlan(NamedTuple):
    """How the backward kernels launch: ``path`` (PATH_SIMT or PATH_MMA);
    a block owns ``rows`` rows (query rows for dq, key rows for dk/dv)
    and streams the other operand ``tile`` rows at a time through
    ``stages`` stages; ``threads`` a block, ``smem`` bytes of dynamic
    shared memory (the same for dq and dk/dv)."""
    path: int
    rows: int
    tile: int
    stages: int
    threads: int
    smem: int


def bwd_plan(d: int, dtype: torch.dtype, aligned: bool = True) -> BwdPlan:
    """The backward's body for head dim ``d`` and the inputs' dtype, from
    those alone and ``aligned`` (q, k, v, do and the outputs start on
    16-byte boundaries, as fresh tensors do; the tensor-core body copies
    16 bytes at a time). Head dims 64 and 128 take the tensor-core body:
    warps of 16 rows, the block's own rows (fp32, padded to d + 4), two
    stages of tiles in the inputs' dtype and the current tile's TF32
    planes (hi and lo for fp32, hi alone for bf16) side by side in shared
    memory: 8 warps and 64-row tiles for fp32 at d 64 (the training
    path), else 4 warps and tiles of 32 rows (d 64) or 16 (d 128). d 256,
    or unaligned operands, take the first design (fp32 rows padded to d +
    1)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"bwd_plan: head dim {d} not in {HEAD_DIMS}")
    size = torch.tensor([], dtype=dtype).element_size()
    if d <= 128 and aligned:
        wide = size == 4 and d == 64
        warps = 8 if wide else 4
        tile = 64 if wide else 32 if d <= 64 else 16
        rows, ld = 16 * warps, d + 4
        planes = 2 if size == 4 else 1
        smem = (4 * 2 * rows * ld + BWD_STAGES * 2 * tile * d * size
                + 4 * (BWD_STAGES * 2 * tile + 2 * planes * tile * ld
                       + 2 * tile))
        return BwdPlan(PATH_MMA, rows, tile, BWD_STAGES, 32 * warps, smem)
    b = 64 if d <= 128 else 32
    smem = 4 * (4 * b * (d + 1) + b * (b + 1) + 2 * b)
    return BwdPlan(PATH_SIMT, b, b, 1, BWD_SIMT_THREADS, smem)


class FwdPlan(NamedTuple):
    """How the forward kernel launches: ``path`` (PATH_SIMT or PATH_MMA);
    a block owns ``rows`` query rows and streams K and V ``tile`` keys at
    a time through ``stages`` stages; ``threads`` a block, ``smem`` bytes
    of dynamic shared memory."""
    path: int
    rows: int
    tile: int
    stages: int
    threads: int
    smem: int


def fwd_plan(d: int, dtype: torch.dtype, aligned: bool = True) -> FwdPlan:
    """The forward's body for head dim ``d`` and the inputs' dtype, from
    those alone and ``aligned`` (q, k, v and o start on 16-byte
    boundaries). Head dims 64 and 128 take the tensor cores: warps of 16
    query rows, K and V streamed 32 keys at a time through a ring of
    cp.async stages in the inputs' dtype, rows padded by 16 bytes. fp32
    (3xTF32): 8 warps at d 64, else 4, two stages, each tile's TF32 planes
    (K hi and lo as rows of d + 4, V hi and lo transposed as rows of tile
    + 8) and the block's fp32 Q rows (d + 4). bf16 (m16n8k16): 4 warps,
    three stages, Q in registers. d 256, or unaligned operands, take the
    first design (fp32 rows padded to d + 1)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"fwd_plan: head dim {d} not in {HEAD_DIMS}")
    size = torch.tensor([], dtype=dtype).element_size()
    if d <= 128 and aligned:
        fp32 = size == 4
        warps = 8 if fp32 and d == 64 else 4
        tile = 32
        stages = 2 if fp32 else 3
        rows = 16 * warps
        planes = 2 * tile * (d + 4) + 2 * d * (tile + 8) if fp32 else 0
        q_rows = rows * (d + 4) if fp32 else 0
        smem = (stages * 2 * tile * (d + 16 // size) * size
                + 4 * (planes + q_rows))
        return FwdPlan(PATH_MMA, rows, tile, stages, 32 * warps, smem)
    b = 64 if d <= 128 else 32
    smem = 4 * (2 * b * (d + 1) + b * (b + 1))
    return FwdPlan(PATH_SIMT, b, b, 1, BWD_SIMT_THREADS, smem)


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    p, i, f = _checks.ptr, ctypes.c_int, ctypes.c_float
    outs = {"apex_flash_fwd": 2, "apex_flash_dq": 1, "apex_flash_dkv": 2}
    ins = 3 if symbol == "apex_flash_fwd" else 6
    return _build.function("flash_attention", symbol,
                           [p] * (ins + 1 + outs[symbol])
                           + [i, i, i, i, f, i, i, i, i, p])


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


def _common(q, scale, causal, window, slopes, code, path):
    """The C functions' trailing arguments, and the slopes' pointer. A
    window of s or more masks nothing more than causality and goes to the
    kernel as s (a C int)."""
    b, n, s, d = q.shape
    window = 0 if window is None else min(int(window), s)
    return [b * n, n, s, d, float(scale), int(bool(causal)), window,
            code, path, _checks.stream(q)], (0 if slopes is None
                                             else slopes.data_ptr())


def _pairs(q, causal, window):
    """Query-key pairs a launch attends over every head, times the head
    dim: the unit of the kernels' FLOPs (the forward's two products a
    pair, qk and pv, are 4 FLOPs a unit; the dq kernel's three with the
    recomputed scores 6; the dk/dv kernel's four 8)."""
    b, n, s, d = q.shape
    w = s if window is None else min(int(window), s)
    if causal:
        pairs = s * (s + 1) // 2 if w >= s else \
            w * (w + 1) // 2 + (s - w) * w
    else:
        pairs = s * w
    return float(b * n * pairs * d)


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
    tail, slopes_ptr = _common(q, scale, causal, window, slopes, code,
                               _fwd_path(q, k, v, o))
    with torch.cuda.device(q.device):
        rc = _kernel("apex_flash_fwd")(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), slopes_ptr, o.data_ptr(),
                                       lse.data_ptr(), *tail)
    _checks.status("flash_fwd", rc)
    registry.count(FLASH_FWD, flops=4.0 * _pairs(q, causal, window),
                   bytes=registry.nbytes(q, k, v, o, lse))
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


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _fwd_path(q, k, v, o):
    """The body :func:`fwd_plan` names for these tensors."""
    return fwd_plan(q.shape[-1], q.dtype, _aligned(q, k, v, o)).path


def _bwd_path(q, k, v, do, *outs):
    """The body :func:`bwd_plan` names for these tensors."""
    return bwd_plan(q.shape[-1], q.dtype, _aligned(q, k, v, do, *outs)).path


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
    tail, slopes_ptr = _common(q, scale, causal, window, slopes, code,
                               _bwd_path(q, k, v, do, dq))
    with torch.cuda.device(q.device):
        rc = _kernel("apex_flash_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), slopes_ptr, dq.data_ptr(),
            *tail)
    _checks.status("flash_dq", rc)
    registry.count(FLASH_DQ, flops=6.0 * _pairs(q, causal, window),
                   bytes=registry.nbytes(q, k, v, do, lse, delta, dq))
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
    tail, slopes_ptr = _common(q, scale, causal, window, slopes, code,
                               _bwd_path(q, k, v, do, dk, dv))
    with torch.cuda.device(q.device):
        rc = _kernel("apex_flash_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), slopes_ptr, dk.data_ptr(),
            dv.data_ptr(), *tail)
    _checks.status("flash_dkv", rc)
    registry.count(FLASH_DKV, flops=8.0 * _pairs(q, causal, window),
                   bytes=registry.nbytes(q, k, v, do, lse, delta, dk, dv))
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
    kernels pick their own tiles (the forward's follow :func:`fwd_plan`,
    the backward's :func:`bwd_plan`) and take any sequence length, so
    nothing here falls back to the einsum reference.
    The function saves q, k, v, o and lse for the backward, never an [s,
    s] matrix."""
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
