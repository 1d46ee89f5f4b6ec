"""The flash forward kernel's launch plan (``apex_tpu_torch.contrib.fmha``
``fwd_plan``) and a PyTorch model of its tensor-core arithmetic
(``csrc/flash_attention.cu`` ``mma_fwd_kernel``, ``bf16_fwd_kernel``), on
the CPU.

The plan picks, from the head dim, the dtype and alignment alone, the
tensor-core body (head dims 64 and 128) or the first design (256, or an
operand off a 16-byte boundary); the tests hold each case to its branch,
its shared memory to the sum of its parts and the card's 227 KB, its grid
and key ranges to every visible pair of ragged sequences, and its numbers
to the kernel source's constants.

The model repeats the kernels' arithmetic tile by tile: each block of
``plan.rows`` query rows visits its key tiles of ``plan.tile`` keys in
ascending order and keeps the online softmax's fp32 running max, sum and
output. fp32 inputs: q * scale, k, v and p split into TF32 terms hi =
rna(a) and lo = rna(a - hi) (emulated on the bits as ``(bits + 0x1000) &
~0x1FFF``), each product summing lo.hi, hi.lo and hi.hi over each k step
of 8 into the fp32 accumulator, as mma.sync.m16n8k8 does. bf16 inputs: k
and v exact, p split into three bf16 terms (hi = bf16(p), mid =
bf16(p - hi), lo = bf16(p - hi - mid)), q * scale one term where the
scale is a power of two and three otherwise, each k step of 16 adding the
terms' products smallest first, as mma.sync.m16n8k16 does. It is held
against JAX's Pallas ``_flash_fwd_pallas`` in interpret mode, and against
the port's ``flash_fwd_plain``, within ``tests/test_torch_flash.py``'s
tolerance (o: fp32 1e-5 relative plus 1e-5 of the largest |o|, never under
1e-5; bf16 one ulp plus 2**-8 of the largest; lse: 1e-5 relative plus
1e-5). The same model with p as one term (fp32: hi alone) falls outside
that tolerance on the fp32 cases, so p's split is what keeps P.V at fp32
accuracy.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.fmha as jax_fmha
from apex_tpu_torch.contrib import fmha
from torch_threads import one_torch_thread  # noqa: F401

_SOURCE = (Path(fmha.__file__).resolve().parent.parent / "csrc"
           / "flash_attention.cu")
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# tests/test_torch_flash.py's _TOL and ATOL_FLOOR
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -8)}
ATOL_FLOOR = 1e-5
LSE_TOL = 1e-5
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100
MMA, SIMT = fmha.PATH_MMA, fmha.PATH_SIMT


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fmha, "_INTERPRET", True)
    monkeypatch.setattr(jax_fmha, "_use_pallas", lambda: True)


# ------------------------------------------------------------- the plan

# (d, dtype, aligned) -> (path, rows, tile, stages, threads, smem bytes)
PLAN_CASES = [
    ((64, "float32", True), (MMA, 128, 32, 2, 256, 107520)),
    ((64, "bfloat16", True), (MMA, 64, 32, 3, 128, 27648)),
    ((128, "float32", True), (MMA, 64, 32, 2, 128, 176128)),
    ((128, "bfloat16", True), (MMA, 64, 32, 3, 128, 52224)),
    ((256, "float32", True), (SIMT, 32, 32, 1, 256, 70016)),
    ((256, "bfloat16", True), (SIMT, 32, 32, 1, 256, 70016)),
    # an operand off a 16-byte boundary: the first design
    ((64, "float32", False), (SIMT, 64, 64, 1, 256, 49920)),
    ((128, "bfloat16", False), (SIMT, 64, 64, 1, 256, 82688)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_plan_picks_the_branch(args, want):
    d, dtype, aligned = args
    p = fmha.fwd_plan(d, _TORCH[dtype], aligned)
    assert tuple(p) == want
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_path_takes_alignment_from_the_pointers(dtype):
    """Fresh tensors take the tensor-core body; a contiguous view off a
    16-byte boundary (here q, then o) takes the first design; d 256
    always does."""
    dt = _TORCH[dtype]
    k, v, o = (torch.zeros(1, 2, 8, 64, dtype=dt) for _ in range(3))
    flat = torch.zeros(2 * 8 * 64 + 8, dtype=dt)
    off = flat[4 // flat.element_size():][:2 * 8 * 64].view(1, 2, 8, 64)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    assert fmha._fwd_path(k.clone(), k, v, o) == MMA
    assert fmha._fwd_path(off, k, v, o) == SIMT
    assert fmha._fwd_path(k, k, v, off) == SIMT
    wide = [torch.zeros(1, 2, 8, 256, dtype=dt) for _ in range(4)]
    assert fmha._fwd_path(*wide) == SIMT


def test_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        fmha.fwd_plan(96, torch.float32)


@pytest.mark.parametrize("d", fmha.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smem_is_the_sum_of_its_parts(d, dtype):
    """The tensor-core body's shared memory: ``stages`` stages of a K and
    a V tile in the inputs' dtype, rows padded by 16 bytes; for fp32 the
    tile's TF32 planes (K hi and lo as rows of d + 4, V hi and lo
    transposed as rows of tile + 8) and the block's fp32 Q rows (d +
    4)."""
    p = fmha.fwd_plan(d, _TORCH[dtype])
    if p.path != MMA:
        assert d == 256
        return
    size = 4 if dtype == "float32" else 2
    ring = p.stages * 2 * p.tile * (d * size + 16)
    planes = (4 * (2 * p.tile * (d + 4) + 2 * d * (p.tile + 8))
              if size == 4 else 0)
    q_rows = 4 * p.rows * (d + 4) if size == 4 else 0  # bf16 Q: registers
    assert p.smem == ring + planes + q_rows <= SMEM_LIMIT
    assert p.rows == 16 * (p.threads // 32)  # warps of 16 rows
    assert p.tile % 16 == 0 and p.tile >= 32


def _key_tiles(plan, q0, s, causal, window, skip_last=False):
    """The forward's key tiles for the block of rows [q0, q0 + plan.rows):
    up to its last row (causal), from the window's first key rounded down
    to a tile; ``skip_last``: the SkipLast fault's range."""
    begin, end = 0, s
    if causal:
        end = min(s, q0 + plan.rows)
        if window:
            begin = max(q0 - window + 1, 0) // plan.tile * plan.tile
    starts = list(range(begin, end, plan.tile))
    return starts[:-1] if skip_last and causal and starts else starts


def _visible(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    if not causal:
        return np.ones((s, s), bool)
    return (j <= i) & ((i - j < window) if window else True)


@pytest.mark.parametrize("s", [1, 77, 200, 300, 2048])
@pytest.mark.parametrize("d,dtype", [(64, "float32"), (64, "bfloat16"),
                                     (128, "float32"), (128, "bfloat16")])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (True, 1), (False, None)])
def test_grid_and_key_ranges_cover_every_visible_pair(s, d, dtype, causal,
                                                      window):
    """Every row of [0, s) has one block; each block's key tiles start on
    tile boundaries, rise, stay inside [0, s) and hold every key visible
    to a row of the block, each once; with the SkipLast fault's range some
    block loses a visible pair."""
    p = fmha.fwd_plan(d, _TORCH[dtype])
    blocks = -(-s // p.rows)
    assert (blocks - 1) * p.rows < s <= blocks * p.rows
    vis = _visible(s, causal, window)
    lost = False
    for blk in range(blocks):
        r0 = blk * p.rows
        need = vis[r0:min(s, r0 + p.rows)].any(0)
        starts = _key_tiles(p, r0, s, causal, window)
        assert all(t % p.tile == 0 and 0 <= t < s for t in starts)
        assert starts == sorted(set(starts))
        covered = np.zeros(s, bool)
        for t in starts:
            covered[t:t + p.tile] = True
        assert not (need & ~covered).any(), (blk, starts)
        short = np.zeros(s, bool)
        for t in _key_tiles(p, r0, s, causal, window, skip_last=True):
            short[t:t + p.tile] = True
        lost |= bool((need & ~short).any())
    assert lost or not causal


def test_plan_constants_match_the_kernel_source():
    """The plan mirrors csrc/flash_attention.cu's FwdLayout: warps,
    tiles, stages, where Q lives, padded rows, the shared-memory layout,
    the grid and the key ranges; the path codes as the backward's."""
    src = _SOURCE.read_text()
    for line in (
            "static constexpr int kWarps = kSplit && D == 64 ? 8 : 4;",
            "static constexpr int kTile = 32;",
            "static constexpr int kStages = kSplit ? 2 : 3;",
            "static constexpr int kRows = 16 * kWarps;",
            "static constexpr int kLdT = D + 16 / static_cast<int>"
            "(sizeof(T));",
            "static constexpr int kLd = D + 4;",
            "static constexpr int kLdV = kTile + 8;",
            "static constexpr int kStage = 2 * kTile * kLdT;",
            "static constexpr int kPlanes = kSplit ? 2 * kTile * kLd + 2 * D"
            " * kLdV : 0;",
            "static constexpr int kQ = kSplit ? kRows * kLd : 0;",
            "const dim3 grid(bh, (s + L::kRows - 1) / L::kRows);",
            "k_end = min(s, q0 + ROWS);",
            "if (window > 0) k_begin = max(q0 - window + 1, 0) / R * R;"):
        assert line in src, line
    assert re.search(
        r"kBytes =\s+kStages \* kStage \* static_cast<int>\(sizeof\(T\)\) "
        r"\+ 4 \* \(kPlanes \+ kQ\);", src)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert '#include "kv_attention.cuh"' in src  # m16n8k16 bf16, split3
    assert "std::frexp(scale, &e2) == 0.5f" in src  # one q term: a power
    assert "int window, int dtype, int path, void* stream)" in src
    assert not re.search(r"atomic[A-Z]|\batom\.", src)  # one writer a row


# ------------------------------------------------ the kernels' arithmetic

def tf32(x):
    """x (fp32) rounded to TF32, to nearest with ties away from zero, as
    cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_terms(x, terms):
    """[hi, lo] (terms 2) or [hi] (1) of fp32 x, as the kernels split."""
    hi = tf32(x)
    return [hi, tf32(x - hi)] if terms == 2 else [hi]


def bf16_terms(x, terms):
    """[hi, mid, lo] (terms 3) or [hi] (1) of fp32 x in bf16 (as fp32
    values), each the bf16 rounding of what the terms before it left
    (``split3``)."""
    out, rest = [], x
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def stepped(a_terms, b_terms, step, order):
    """sum_k a[..., k] b[k, ...] as the mma does it: each k step of
    ``step`` adds, into the fp32 accumulator, the products of the pairs of
    terms in ``order`` (index pairs, smallest first)."""
    a0, b0 = a_terms[0], b_terms[0]
    k = a0.shape[-1]
    acc = torch.zeros(*a0.shape[:-1], b0.shape[-1])
    for c in range(0, k, step):
        sl = slice(c, c + step)
        for i, j in order:
            acc = acc + a_terms[i][..., sl] @ b_terms[j][..., sl, :]
    return acc


# pairs of (a term, b term), smallest first: 3xTF32 (lo.hi, hi.lo,
# hi.hi) and, with one term, hi.hi alone
_TF32 = {2: ((1, 0), (0, 1), (0, 0)), 1: ((0, 0),)}


def _products(dtype, p_terms):
    """(S = Q.K^T, P.V) as the kernel's products for the inputs' dtype:
    functions of (q*scale, k) and (p, v) in fp32. ``p_terms`` overrides
    p's term count (the single-term variant)."""
    if dtype == torch.float32:
        def qk(qs, k):
            return stepped(tf32_terms(qs, 2), tf32_terms(k.transpose(-1, -2),
                                                         2), 8, _TF32[2])

        def pv(p, v):
            n = 2 if p_terms is None else p_terms
            order = _TF32[2] if n == 2 else ((0, 1), (0, 0))
            return stepped(tf32_terms(p, n), tf32_terms(v, 2), 8, order)
        return qk, pv

    def qk_bf16(qs, k, q_terms):
        terms = bf16_terms(qs, q_terms)
        kt = k.transpose(-1, -2)
        return stepped(terms, [kt], 16,
                       [(i, 0) for i in reversed(range(q_terms))])

    def pv(p, v):
        n = 3 if p_terms is None else p_terms
        return stepped(bf16_terms(p, n), [v], 16,
                       [(i, 0) for i in reversed(range(n))])
    return qk_bf16, pv


def mma_fwd_model(q, k, v, scale, causal, window=None, slopes=None,
                  p_terms=None):
    """(o in q's dtype, lse fp32) as the tensor-core forward computes
    them, block by block and tile by tile in fwd_plan's shapes."""
    dtype = q.dtype
    plan = fmha.fwd_plan(q.shape[-1], dtype)
    assert plan.path == MMA
    b, n, s, d = q.shape
    qk, pv = _products(dtype, p_terms)
    if dtype == torch.bfloat16:
        q_terms = 1 if np.frexp(scale)[0] == 0.5 else 3
        product = functools.partial(qk, q_terms=q_terms)
    else:
        product = qk
    qs = q.float() * scale  # the scale before the product, in fp32
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, plan.tile))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, plan.tile))
    vis = torch.from_numpy(_visible(s, causal, window))
    o = torch.zeros(b, n, s, d)
    lse = torch.zeros(b, n, s)
    for r0 in range(0, s, plan.rows):
        rows = slice(r0, min(s, r0 + plan.rows))
        m = torch.full((b, n, rows.stop - r0, 1), fmha.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, n, rows.stop - r0, d)
        for k0 in _key_tiles(plan, r0, s, causal, window):
            keys = slice(k0, k0 + plan.tile)
            sc = product(qs[:, :, rows], kf[:, :, keys])
            if slopes is not None:
                j = torch.arange(k0, k0 + plan.tile, dtype=torch.float32)
                sc = sc + slopes.float()[None, :, None, None] * j
            live = torch.zeros(rows.stop - r0, plan.tile, dtype=torch.bool)
            width = min(s, k0 + plan.tile) - k0
            live[:, :width] = vis[rows, k0:k0 + width]
            sc = sc.masked_fill(~live, fmha.NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * alpha + pv(p, vf[:, :, keys])
        lc = l.clamp_min(1e-30)
        o[:, :, rows] = acc / lc
        lse[:, :, rows] = (m + torch.log(lc)).squeeze(-1)
    return o.to(dtype), lse


def test_tf32_rounds_to_nearest_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 fraction bits
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      -(1 + ulp / 2), 1 + 3 * ulp / 2], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp])
    assert torch.equal(tf32(x), want)


def test_bf16_terms_hold_fp32_values():
    """Three bf16 terms leave under 2**-24 of each value (the kernel's
    bound 2**-27 is for |p| <= 1 and the same arithmetic), and a power of
    two times a bf16 value is one term."""
    y = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    hi, mid, lo = bf16_terms(y, 3)
    assert ((y - hi - mid - lo).abs() <= y.abs() * 2.0 ** -24).all()
    q = torch.randn(1000, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16).float()
    terms = bf16_terms(q * 0.125, 3)
    assert torch.equal(terms[0], q * 0.125)
    assert not terms[1].any() and not terms[2].any()


# (b, n, s, d, causal, window, alibi, scale, (block_q, block_k) of JAX's
# kernel, dtype); scale None is 1/sqrt(d) (a power of two at d 64). JAX's
# interpret mode runs each grid cell apart, so most cases take one block;
# the multi-block ones hold the model to JAX's own online softmax.
CASES = [
    (1, 2, 256, 64, True, None, False, None, (64, 64), "float32"),
    (1, 2, 200, 64, True, 37, True, None, (100, 100), "float32"),
    (2, 2, 77, 64, False, None, True, 0.3, (77, 77), "float32"),
    (1, 3, 200, 128, True, None, False, None, (200, 200), "float32"),
    (1, 2, 256, 64, True, 37, False, None, (128, 128), "bfloat16"),
    (2, 2, 77, 64, False, None, False, 0.1, (77, 77), "bfloat16"),
    (1, 2, 200, 128, False, None, True, None, (200, 200), "bfloat16"),
    (2, 1, 1, 128, True, None, False, None, (1, 1), "bfloat16"),
]
IDS = [f"b{b}n{n}-s{s}-d{d}-{'causal' if c else 'full'}-w{w}-"
       f"{'alibi' if a else 'noalibi'}-scale{sc}-{dt}"
       for b, n, s, d, c, w, a, sc, _, dt in CASES]


def _inputs(case):
    b, n, s, d, causal, window, alibi, scale, _, dtype = case
    rng = np.random.RandomState(7 * s + d + (window or 0) + 3 * alibi
                                + causal + b * n)
    q, k, v = (rng.randn(b, n, s, d).astype(np.float32) for _ in range(3))
    slopes = (rng.uniform(0.01, 0.2, size=n).astype(np.float32) if alibi
              else None)
    return q, k, v, slopes, (1.0 / np.sqrt(d) if scale is None else scale)


@functools.lru_cache(maxsize=None)
def _jax(case):
    """JAX's o and lse (the Pallas forward in interpret mode) as fp32
    numpy arrays."""
    _, _, _, _, causal, window, _, _, (bq, bk), dtype = case
    q, k, v, slopes, scale = _inputs(case)
    jq, jk, jv = (jnp.asarray(a, _JAX[dtype]) for a in (q, k, v))
    jsl = None if slopes is None else jnp.asarray(slopes)
    o, lse = jax_fmha._flash_fwd_pallas(jq, jk, jv, float(scale), causal,
                                        bq, bk, window, jsl)
    return (np.array(o.astype(jnp.float32), dtype=np.float32),
            np.array(lse, dtype=np.float32))


def _torch_args(case):
    _, _, _, _, causal, window, _, _, _, dtype = case
    q, k, v, slopes, scale = _inputs(case)
    dt = _TORCH[dtype]
    q, k, v = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    return (q, k, v, float(scale), causal, window,
            None if slopes is None else torch.from_numpy(slopes))


@functools.lru_cache(maxsize=None)
def _model(case, p_terms=None):
    """The model's (o, lse) on the case's inputs."""
    return mma_fwd_model(*_torch_args(case), p_terms=p_terms)


def _outside(got, want, dtype):
    """The largest |got - want| as a share of the tolerance (> 1: out)."""
    rtol, scaled_atol = _TOL[dtype]
    atol = max(scaled_atol * np.abs(want).max(), ATOL_FLOOR)
    err = np.abs(got.float().numpy() - want)
    return float((err / (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_matches_jax_kernel(case):
    o, lse = _model(case)
    o_jax, lse_jax = _jax(case)
    assert o.dtype == _TORCH[case[-1]] and o.shape == o_jax.shape
    assert _outside(o, o_jax, case[-1]) <= 1.0
    np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_matches_the_plain_version(case):
    """The model and the port's plain version (the card's yardstick, fp32
    matmuls) agree within the same tolerance."""
    o, lse = _model(case)
    o_p, lse_p = fmha.flash_fwd_plain(*_torch_args(case))
    assert _outside(o, o_p.float().numpy(), case[-1]) <= 1.0
    torch.testing.assert_close(lse, lse_p, rtol=LSE_TOL, atol=LSE_TOL)


def test_single_term_p_fails():
    """P.V with p as one TF32 term (k, v and q * scale still split) reads
    past the tolerance on the fp32 cases, where the model holds."""
    readings = []
    for case in CASES:
        if case[-1] != "float32" or case[2] < 64:
            continue
        o, _ = _model(case, p_terms=1)
        readings.append(_outside(o, _jax(case)[0], "float32"))
    assert max(readings) > 1.0, readings
    assert sum(r > 1.0 for r in readings) >= len(readings) // 2, readings


def test_bf16_model_terms_matter():
    """In bf16, one term for a q * scale that is not a power of two moves
    the scores by bf16 roundings (past 1e-3 of the float64 product), where
    three terms stay within 1e-5 and the model's lse within its
    tolerance of JAX's."""
    case = next(c for c in CASES if c[-1] == "bfloat16" and c[7] == 0.1)
    q, k, v, scale, causal, window, slopes = _torch_args(case)
    _, lse_jax = _jax(case)
    qk, _ = _products(torch.bfloat16, None)
    qs = q.float() * scale
    s1 = qk(qs, k.float(), q_terms=1)
    s3 = qk(qs, k.float(), q_terms=3)
    exact = torch.matmul(qs.double(), k.double().transpose(-1, -2))
    assert (s3.double() - exact).abs().max() < 1e-5
    assert (s1.double() - exact).abs().max() > 1e-3
    _, lse = mma_fwd_model(q, k, v, scale, causal, window, slopes)
    np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=LSE_TOL,
                               atol=LSE_TOL)
