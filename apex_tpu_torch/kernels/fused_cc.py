"""The fused computation-collective kernels of
``apex_tpu/kernels/fused_cc.py``: the CUDA kernels and their plain
PyTorch versions.

Family (a), the tensor-parallel projections joined to their collective
(mesh2d's row-parallel ``wo``): :func:`matmul_reduce_from` runs the GEMM
in column tiles and all-reduces each tile as it is done;
:func:`matmul_reduce_scatter` and :func:`all_gather_matmul` run their
rings, one send to the next rank and one receive from the previous a
step, with a chunk GEMM between. The GEMM is :func:`_matmul`, kernel #20
(csrc/fused_cc_matmul.cu, counted as ``tp_matmul``); its plain version is
:func:`matmul_plain`. Each fused form hands the collectives exactly the
elements of its unfused form: T all-reduces of payload/T are one of the
payload, g - 1 ring steps of a 1/g chunk are one reduce-scatter or
all-gather.

Family (b): ``window_attention`` (the prefill and verify window) and
``spec_verify_attention`` (the verify window read straight from the int8
blockwise serving store). Each batch row may sit at its own offset: the
serving engine's slots are at different fill levels (the JAX functions
take one scalar start and run under ``vmap`` over slots). The fused int4
kernels of family (c) are in :mod:`apex_tpu_torch.kernels.quant4`, beside
the unfused ones they fuse.
"""

import ctypes
import functools

import torch
import torch.distributed as dist

from apex_tpu_torch.kernels import (
    _build,
    _checks,
    kv_attention,
    quant,
    registry,
)
from apex_tpu_torch.parallel import groups

NEG_INF = -1e30
# column tiles of matmul_reduce_from: each tile's all-reduce follows its
# GEMM
DEFAULT_TILES = 4
# #20's launch plan (csrc/fused_cc_matmul.cu): block tiles, largest
# first; the K step; splits of K at most (each at least one K step)
MM_TILES = ((128, 128), (128, 64), (64, 64))
MM_STEP = 32
MM_MAX_SPLITS = 16
TP_MATMUL = registry.register("tp_matmul")
WINDOW_ATTENTION = registry.register("window_attention")
SPEC_VERIFY = registry.register("spec_verify")
# apex_spec_verify's paths: #22's first design and the split tensor-core
# body (2 and 3 are planted faults of the body, passed only by the card
# checks)
VERIFY_FIRST_DESIGN, VERIFY_SPLIT = 0, 1


# ------------------------------------------- family (a): GEMM + collective

def matmul_plain(x, w):
    """``x @ w`` accumulated in fp32 and cast to the result type of x and
    w, as the TPU kernel computes it (x [..., k], w [k, n])."""
    return torch.matmul(x.float(), w.float()).to(torch.result_type(x, w))


def plan(m: int, n: int, k: int, sms: int):
    """(bm, bn, splits) of #20 for out [m, n] = x [m, k] @ w [k, n] on a
    card of ``sms`` SMs, from the shape alone (never the dtype: a bf16
    output must be the rounding of the same fp32 sum as an fp32 output).
    The largest tile of MM_TILES whose output tiles number at least the
    SMs runs unsplit (S = 1: a split's fp32 partials cost more than the
    fuller card gains, measured at GPT-2's tiles); where none does, the
    smallest tile splits K into the S nearest to two blocks an SM, at most
    MM_MAX_SPLITS and one split a K step of MM_STEP. GPT-2's [8192, k] x
    [k, 256] tiles take 128 x 64 and S = 1; tp_dp's [128, 1024] x [1024,
    64] 64 x 64 and S = 16, its [128, 256] x [256, 64] S = 8."""
    for bm, bn in MM_TILES:
        tiles = -(-m // bm) * -(-n // bn)
        if tiles >= sms:
            return bm, bn, 1
    most = min(MM_MAX_SPLITS, -(-k // MM_STEP))
    return bm, bn, max(1, min(most, (2 * sms + tiles // 2) // tiles))


def workspace(device, m: int, n: int, k: int, splits=None):
    """((bm, bn, splits), scratch, counters) for one #20 launch: the plan
    (``splits`` forced where given: the card checks), and with S > 1 the
    fp32 partial tiles and the device's zeroed int32 counters (shared
    with #21/#25, in stream order); with S = 1 neither (None)."""
    bm, bn, planned = plan(m, n, k, kv_attention.sm_count(device.index))
    splits = planned if splits is None else splits
    if splits == 1:
        return (bm, bn, 1), None, None
    tiles = -(-m // bm) * -(-n // bn)
    scratch = torch.empty(tiles * splits * bm * bn, dtype=torch.float32,
                          device=device)
    return (bm, bn, splits), scratch, kv_attention.counters(device, tiles)


@functools.lru_cache(maxsize=1)
def _mm_kernel():
    p, i, ll = _checks.ptr, ctypes.c_int, ctypes.c_longlong
    return _build.function("fused_cc_matmul", "apex_tp_matmul",
                           [p, p, p, i, i, i, ll, ll, i, i, i, i, i, p, p,
                            p])


def mm_launch(x2, w, out, k, splits=None):
    """Launch #20 through its C function, uncounted: out [m, n] = x2[:, :k]
    @ w[:k] (rows of each contiguous) on the plan for (m, n, k), S forced
    to ``splits`` where given. The wrapper's launch, and the card checks'
    (planted faults, forced splits)."""
    (bm, bn, s), scratch, counters = workspace(x2.device, x2.shape[0],
                                               w.shape[1], k, splits)
    with torch.cuda.device(x2.device):
        rc = _mm_kernel()(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                          x2.shape[0], w.shape[1], k, x2.stride(0),
                          w.stride(0), _checks.DTYPE_CODES[x2.dtype],
                          _checks.DTYPE_CODES[w.dtype], bm, bn, s,
                          _checks.data_ptr(scratch),
                          _checks.data_ptr(counters), _checks.stream(x2))
    _checks.status("tp_matmul", rc)
    return out


def _matmul(x, w):
    """``x @ w`` (x [..., k] fp32 or bf16, w [k, n] fp32 or bf16), fp32
    accumulation, in the result type of x and w: the compute half of every
    fused form. A CPU tensor takes :func:`matmul_plain`; a CUDA tensor
    launches kernel #20 or raises. w may be a column slice of a wider
    matrix (its rows any distance apart, its columns adjacent): the kernel
    reads it in place."""
    name = "tp_matmul"
    if not _checks.on_cuda(name, x, w):
        return matmul_plain(x, w)
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: x [..., k] and w [k, n] do not match: "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    _checks.dtype_code(name, x, "x")
    _checks.dtype_code(name, w, "w")
    lead, (k, n) = x.shape[:-1], w.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if not (m and n and k):
        raise ValueError(f"{name}: empty product {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x2.stride(1) != 1 or w.stride(1) != 1:
        raise ValueError(f"{name}: the rows of x and w must each be "
                         f"contiguous")
    out = torch.empty(m, n, dtype=torch.result_type(x, w), device=x.device)
    mm_launch(x2, w, out, k)
    registry.count(TP_MATMUL, flops=2.0 * m * n * k,
                   bytes=registry.nbytes(x2, w, out))
    return out.reshape(*lead, n)


def _col_tiles(n, want=DEFAULT_TILES):
    """Largest tile count <= ``want`` dividing the output width."""
    for t in range(min(want, n), 0, -1):
        if n % t == 0:
            return t
    return 1


class _MatmulReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, tiles):
        t = _col_tiles(w.shape[-1], tiles)
        tn = w.shape[-1] // t
        outs = []
        for i in range(t):
            tile = _matmul(x, w[:, i * tn:(i + 1) * tn])
            dist.all_reduce(tile, group=group)
            outs.append(tile)
        ctx.save_for_backward(x, w)
        return torch.cat(outs, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        # reduce_from is the identity under transposition; the products
        # are the plain local ones (dw is this rank's shard's gradient, dx
        # feeds copy_to, whose backward all-reduces it)
        x, w = ctx.saved_tensors
        dx = torch.matmul(dy, w.t().to(dy.dtype)).to(x.dtype)
        dy2 = dy.reshape(-1, dy.shape[-1])
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t().to(dy.dtype),
                          dy2).to(w.dtype)
        return dx, dw, None, None


def matmul_reduce_from(x, w, axis_name, tiles=DEFAULT_TILES):
    """The row-parallel projection joined to the TP reduction:
    ``reduce_from(x @ w)``, an all-reduce over the axis's group forward
    and the identity backward. The GEMM runs in ``tiles`` column tiles
    (kernel #20 on the card) and each tile is all-reduced when it is done,
    also at world size 1, as JAX sums over a one-device axis; the tiles
    hand the collective the elements of the one unfused all-reduce."""
    return _MatmulReduceFrom.apply(x, w, groups.axis_group(axis_name),
                                   tiles)


def _product(x, w):
    """``x @ w`` in the result type of x and w, as ``jnp`` promotes: the
    unfused product JAX's rings take at g <= 1."""
    dtype = torch.result_type(x, w)
    return torch.matmul(x.to(dtype), w.to(dtype))


def _no_grad_ring(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the ring has no backward here (no library path "
            f"differentiates it); call it under torch.no_grad()")


def _ring_neighbours(group):
    """(global rank of the next rank, of the previous rank) of the ring
    r -> r + 1 over ``group``."""
    g, r = dist.get_world_size(group), dist.get_rank(group)
    return (dist.get_global_rank(group, (r + 1) % g),
            dist.get_global_rank(group, (r - 1) % g))


def _ppermute(t, group, nxt, prv):
    """Send ``t`` to the next rank and receive the previous rank's."""
    got = torch.empty_like(t)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, got, prv, group)]):
        req.wait()
    return got


def matmul_reduce_scatter(x, w, axis_name):
    """``reduce_scatter(x @ w)`` over the leading axis: each rank ends with
    its 1/g row slice of the summed product. At g > 1 a ring: at step s
    each rank adds the chunk GEMM (#20) of the partial sum passing through
    it and hands it on, so only an [m/g, n] chunk is live; g - 1 sends of
    1/g of the product, the elements of one reduce-scatter. At g <= 1 the
    product ``x @ w``, as JAX. Rows that g does not divide raise
    ValueError, as JAX's reduce-scatter of the whole product does.
    Forward only."""
    name = "matmul_reduce_scatter"
    _no_grad_ring(name, x, w)
    m = x.shape[0]
    g = groups.axis_size(axis_name)
    if g <= 1:
        return _product(x, w)
    if m % g:
        raise ValueError(f"{name}: {m} rows do not split over {g} ranks "
                         f"(JAX's psum_scatter refuses them too)")
    group = groups.axis_group(axis_name)
    r = dist.get_rank(group)
    nxt, prv = _ring_neighbours(group)
    chunk = m // g
    acc = None
    for s in range(g):
        c = (r - 1 - s) % g
        part = _matmul(x[c * chunk:(c + 1) * chunk], w)
        acc = part if acc is None else _ppermute(acc, group, nxt, prv) + part
    return acc


def all_gather_matmul(x_shard, w, axis_name):
    """``all_gather(x_shard) @ w`` (the shards stacked along rows): each
    rank GEMMs (#20) the chunk it holds into its rows of the output while
    the ring passes the chunks on, so the gathered activation never
    exists; g - 1 sends of one shard, the elements of one all-gather. At
    g <= 1 the product ``x_shard @ w``, as JAX. Forward only."""
    _no_grad_ring("all_gather_matmul", x_shard, w)
    g = groups.axis_size(axis_name)
    if g <= 1:
        return _product(x_shard, w)
    group = groups.axis_group(axis_name)
    r = dist.get_rank(group)
    nxt, prv = _ring_neighbours(group)
    ms = x_shard.shape[0]
    out = torch.empty(g * ms, w.shape[-1],
                      dtype=torch.result_type(x_shard, w),
                      device=x_shard.device)
    cur = x_shard
    for s in range(g):
        src = (r - s) % g
        out[src * ms:(src + 1) * ms] = _matmul(cur, w)
        if s < g - 1:
            cur = _ppermute(cur, group, nxt, prv)
    return out


# ------------------------------------- family (b): window attention


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
        [p, p, p, p, i, i, i, i, i, i, p, i, f, f, i, i, p, p, p])


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
    (head dim 64 or 128, any T, tensors on 16-byte boundaries) or raises:
    one launch, the live range split over the SMs where the row tiles
    leave them idle (``kv_attention.plan``)."""
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
    _checks.aligned16("window_attention", qg=qg, kt=kt, vt=vt)
    code = _checks.dtype_code("window_attention", qg, "qg")
    starts = _checks.row_offsets("window_attention", start, b, qg.device,
                                 "start")
    out = torch.empty(qg.shape, dtype=torch.float32, device=qg.device)
    with torch.cuda.device(qg.device):
        splits, scratch, counters = kv_attention.workspace(
            qg.device, w * rep, b * g, d)
        rc = _kernel()(qg.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                       out.data_ptr(), w, b, g, rep, d, T, starts.data_ptr(),
                       window or 0, float(sm_scale), float(softcap or 0.0),
                       code, splits, _checks.data_ptr(scratch),
                       _checks.data_ptr(counters), _checks.stream(qg))
    _checks.status("window_attention", rc)
    registry.count(WINDOW_ATTENTION, flops=4.0 * b * g * rep * w * d * T,
                   bytes=registry.nbytes(qg, kt, vt, out))
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
        [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, f, i, i, p, p, i, p])


def verify_plan(q_itemsize: int, d: int, block: int, aligned: bool) -> int:
    """#22's body for queries of ``q_itemsize`` bytes at head dim ``d``
    over a store of ``block``-lane blocks: VERIFY_SPLIT, the split
    tensor-core body of #21 with an int8 stage, where q is bf16, d is 64
    or 128, each cell's d lanes lie in one block (block % d == 0: one
    scale a key row) and q and the codes lie on 16-byte boundaries
    (``aligned``; the rows, a multiple of d bytes, then stay aligned);
    else VERIFY_FIRST_DESIGN."""
    if q_itemsize == 2 and d in (64, 128) and block % d == 0 and aligned:
        return VERIFY_SPLIT
    return VERIFY_FIRST_DESIGN


def _launch_verify(q5, kq4, ks4, vq4, vs4, starts, sm_scale, path,
                   splits=None):
    """#22 through its C function on ``path`` over batched operands (q5
    [w, b, g, rep, d], the store [T, b, nb, *], starts an int32 [b] on
    the device), unchecked and uncounted (:func:`spec_verify_attention`
    checks and counts; the card checks force paths and splits here):
    ctx [w, b, g, rep, d] fp32. The split body takes S from
    ``kv_attention.plan`` unless ``splits`` is given."""
    w, b, g, rep, d = q5.shape
    T, _, nb, B = kq4.shape
    out = torch.empty(q5.shape, dtype=torch.float32, device=q5.device)
    with torch.cuda.device(q5.device):
        if path == VERIFY_FIRST_DESIGN:
            splits, scratch, counters = 1, None, None
        else:
            splits, scratch, counters = kv_attention.workspace(
                q5.device, w * rep, b * g, d, splits)
        rc = _verify_kernel()(
            q5.data_ptr(), kq4.data_ptr(), ks4.data_ptr(), vq4.data_ptr(),
            vs4.data_ptr(), out.data_ptr(), w, b, g, rep, d, T, nb, B,
            starts.data_ptr(), float(sm_scale), _checks.DTYPE_CODES[q5.dtype],
            splits, _checks.data_ptr(scratch), _checks.data_ptr(counters),
            path, _checks.stream(q5))
    _checks.status("spec_verify_attention", rc)
    return out


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
    launches the kernel (head dim 64 or 128) or raises: one launch, on
    the body :func:`verify_plan` picks (the split tensor-core body for
    bf16 q over the serving store, the live range split over the SMs as
    :func:`window_attention`'s; else the first design)."""
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
    _checks.dtype_code(name, q, "q")
    starts = _checks.row_offsets(name, start, b, q.device, "start")
    path = verify_plan(q.element_size(), d, B,
                       all(t.data_ptr() % 16 == 0 for t in (q, kq, vq)))
    out = _launch_verify(q5, kq4, ks4, vq4, vs4, starts, sm_scale, path)
    registry.count(SPEC_VERIFY, flops=4.0 * q.numel() * T,
                   bytes=registry.nbytes(q, kq, ks, vq, vs, out))
    return out[:, 0] if one else out
