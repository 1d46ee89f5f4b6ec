"""The flash backward kernels' launch plan (``apex_tpu_torch.contrib.fmha``
``bwd_plan``) and a PyTorch model of their tensor-core arithmetic
(``csrc/flash_attention.cu`` ``mma_dq_kernel``, ``mma_dkv_kernel``), on
the CPU.

The plan picks, from the head dim, the dtype and alignment alone, the
tensor-core body (head dims 64 and 128) or the first design (256); the
tests hold each case to its branch, its tiles and shared memory to the
card's 227 KB, its grid and tile ranges to every visible pair of ragged
sequences, and its numbers to the kernel source's constants.

The model repeats the kernels' products: each fp32 operand a splits into
TF32 terms hi = rna(a) and lo = rna(a - hi) (round to nearest, ties away
from zero, emulated on the bits as ``(bits + 0x1000) & ~0x1FFF``), and a
product sums lo_a.hi_b, hi_a.lo_b and hi_a.hi_b over each k step of 8 in
order into an fp32 accumulator, as mma.sync.m16n8k8 does; a bf16 operand
is exact in TF32 (its lo term is 0). It is held against JAX's Pallas
``_flash_bwd_pallas`` in interpret mode within ``tests/test_torch_flash.py``'s
tolerance (fp32: 1e-5 relative plus 1e-5 of the largest |gradient|, never
under 1e-5; bf16: one ulp plus 2**-8 of the largest). The same model with
one term (plain TF32: hi_a.hi_b alone) falls outside that tolerance, so
the split is what keeps the kernels at fp32 accuracy.
"""

import ast
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
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100
MMA, SIMT = fmha.PATH_MMA, fmha.PATH_SIMT


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fmha, "_INTERPRET", True)
    monkeypatch.setattr(jax_fmha, "_use_pallas", lambda: True)


# ------------------------------------------------------------- the plan

# (d, dtype, aligned) -> (path, rows, tile, stages, threads, smem bytes)
PLAN_CASES = [
    ((64, "float32", True), (MMA, 128, 64, 2, 256, 206336)),
    ((64, "bfloat16", True), (MMA, 64, 32, 2, 128, 69376)),
    ((128, "float32", True), (MMA, 64, 16, 2, 128, 134528)),
    ((128, "bfloat16", True), (MMA, 64, 16, 2, 128, 101248)),
    ((256, "float32", True), (SIMT, 32, 32, 1, 256, 136064)),
    ((256, "bfloat16", True), (SIMT, 32, 32, 1, 256, 136064)),
    # an operand off a 16-byte boundary: the first design
    ((64, "float32", False), (SIMT, 64, 64, 1, 256, 83712)),
    ((128, "bfloat16", False), (SIMT, 64, 64, 1, 256, 149248)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_plan_picks_the_branch(args, want):
    d, dtype, aligned = args
    p = fmha.bwd_plan(d, _TORCH[dtype], aligned)
    assert tuple(p) == want
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_path_takes_alignment_from_the_pointers(dtype):
    """Fresh tensors take the tensor-core body; a contiguous view off a
    16-byte boundary (here do) takes the first design."""
    dt = _TORCH[dtype]
    q, k, v = (torch.zeros(1, 2, 8, 64, dtype=dt) for _ in range(3))
    flat = torch.zeros(2 * 8 * 64 + 8, dtype=dt)
    do = flat[4 // flat.element_size():][:2 * 8 * 64].view(1, 2, 8, 64)
    assert do.is_contiguous() and do.data_ptr() % 16 == 4
    assert fmha._bwd_path(q, k, v, q.clone()) == MMA
    assert fmha._bwd_path(q, k, v, do) == SIMT
    assert fmha._bwd_path(torch.zeros(1, 2, 8, 256, dtype=dt), *(
        torch.zeros(1, 2, 8, 256, dtype=dt) for _ in range(3))) == SIMT


def test_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        fmha.bwd_plan(96, torch.float32)


@pytest.mark.parametrize("d", fmha.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mma_smem_is_the_sum_of_its_parts(d, dtype):
    """The tensor-core body's shared memory: the block's own 64 rows of
    two operands in fp32 (rows of d + 4), kStages stages of two tiles in
    the inputs' dtype and of two fp32 vectors, the TF32 planes (hi and lo
    for fp32, hi for bf16) and the current tile's two vectors."""
    p = fmha.bwd_plan(d, _TORCH[dtype])
    if p.path != MMA:
        assert d == 256
        return
    size = 4 if dtype == "float32" else 2
    planes = 2 if dtype == "float32" else 1
    ld = d + 4
    own = 2 * p.rows * ld * 4
    ring = p.stages * 2 * p.tile * (d * size + 4)
    tile = (2 * planes * p.tile * ld + 2 * p.tile) * 4
    assert p.smem == own + ring + tile <= SMEM_LIMIT
    assert p.rows == 16 * (p.threads // 32)  # warps of 16 rows
    assert p.tile % 8 == 0 and p.rows % p.tile == 0


def _grid(plan, bh, s):
    """The launchers' grid: (heads of the batch, row blocks)."""
    return bh, -(-s // plan.rows)


def _dq_key_tiles(plan, q0, s, causal, window):
    """csrc/flash_attention.cu mma_dq_kernel's key tiles for the block of
    rows [q0, q0 + plan.rows): up to its last row (causal), from the
    window's first key rounded down to a tile."""
    begin, end = 0, s
    if causal:
        end = min(s, q0 + plan.rows)
        if window:
            begin = max(q0 - window + 1, 0) // plan.tile * plan.tile
    return range(begin, end, plan.tile)


def _dkv_query_tiles(plan, k0, s, causal, window):
    """mma_dkv_kernel's query tiles for the block of keys [k0, k0 +
    plan.rows): from its first key (causal) up to the window's last
    query."""
    begin, end = 0, s
    if causal:
        begin = k0
        if window:
            end = min(s, k0 + plan.rows - 1 + window)
    return range(begin, end, plan.tile)


def _visible(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    if not causal:
        return np.ones((s, s), bool)
    return (j <= i) & ((i - j < window) if window else True)


@pytest.mark.parametrize("s", [200, 300, 77, 2048])
@pytest.mark.parametrize("d,dtype", [(64, "float32"), (128, "bfloat16"),
                                     (256, "float32")])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 37),
                                           (True, 1), (False, None)])
def test_grid_and_ranges_cover_every_visible_pair(s, d, dtype, causal,
                                                  window):
    """Every row of [0, s) has one block; each dq block's key tiles (and
    each dk/dv block's query tiles) start on tile boundaries, rise, stay
    inside [0, s) and hold every key (query) visible to a row of the
    block, each once; with the SkipLast fault's range, one tile less
    loses a visible pair of some block."""
    p = fmha.bwd_plan(d, _TORCH[dtype])
    bh, blocks = _grid(p, 3, s)
    assert bh == 3 and (blocks - 1) * p.rows < s <= blocks * p.rows
    vis = _visible(s, causal, window)
    lost = False
    for blk in range(blocks):
        r0 = blk * p.rows
        rows = slice(r0, min(s, r0 + p.rows))
        for tiles, need in ((_dq_key_tiles(p, r0, s, causal, window),
                             vis[rows].any(0)),
                            (_dkv_query_tiles(p, r0, s, causal, window),
                             vis[:, rows].any(1))):
            starts = list(tiles)
            assert all(t % p.tile == 0 and 0 <= t < s for t in starts)
            assert starts == sorted(set(starts))
            covered = np.zeros(s, bool)
            for t in starts:
                covered[t:t + p.tile] = True
            assert not (need & ~covered).any(), (blk, starts)
            if causal and starts:
                last = np.zeros(s, bool)
                last[starts[-1]:starts[-1] + p.tile] = True
                lost |= bool((need & last).any())
    assert lost or not causal


def test_plan_constants_match_the_kernel_source():
    """The plan mirrors csrc/flash_attention.cu: rows, warps, stages, the
    tile rule, padded rows, the shared-memory layout, the path codes, and
    the first design's tiles and block."""
    src = _SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kStages") == fmha.BWD_STAGES
    assert const("kThreads") == fmha.BWD_SIMT_THREADS
    assert const("kPathSimt") == fmha.PATH_SIMT
    assert const("kPathMma") == fmha.PATH_MMA
    # the planted faults' codes, which only chip_smoke.py passes
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    faults = ast.literal_eval(re.search(r"^FLASH_FAULTS = (\(.*?\)\))$",
                                        smoke, re.S | re.M).group(1))
    assert dict(faults) == {
        "lo terms dropped": const("kFaultNoLo"),
        "last tile of each causal range skipped": const("kFaultSkipLast")}
    for line in ("static constexpr bool kWide = kSplit && D == 64;",
                 "static constexpr int kWarps = kWide ? 8 : 4;",
                 "static constexpr int kThreads = kWarps * 32;",
                 "static constexpr int kRows = 16 * kWarps;",
                 "static constexpr int kTile = kWide ? 64 : D <= 64 ? 32 "
                 ": 16;"):
        assert line in src, line
    assert "static constexpr int kLd = D + 4;" in src
    assert "static constexpr int kB = D <= 128 ? 64 : 32;" in src
    assert "static constexpr int kPlanes = kSplit ? 2 : 1;" in src
    assert re.search(
        r"kBytes =\s+4 \* 2 \* kRows \* kLd \+ kRing \* static_cast<int>"
        r"\(sizeof\(T\)\) \+\s+4 \* \(kRingVec \+ 2 \* kPlanes \* kPlane "
        r"\+ 2 \* kTile\);", src)
    assert "if constexpr (D <= 128) {" in src  # d 256: the first design
    # the ranges _dq_key_tiles and _dkv_query_tiles mirror
    for line in ("k_end = min(s, q0 + ROWS);",
                 "if (window > 0) k_begin = max(q0 - window + 1, 0) / R * R;",
                 "q_begin = k0;  // a multiple of R",
                 "if (window > 0) q_end = min(s, k0 + ROWS - 1 + window);",
                 "<<<dim3(bh, (s + L::kRows - 1) / L::kRows), L::kThreads, "
                 "smem, stream>>>"):
        assert line in src, line
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
    assert not re.search(r"atomic[A-Z]|\batom\.", src)  # one writer a tile


# ------------------------------------------------ the kernels' arithmetic

def tf32(x):
    """x (fp32) rounded to TF32, to nearest with ties away from zero, as
    cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma_product(a, b, terms=3):
    """a [..., m, k] @ b [..., k, n] in fp32 as the kernels compute it: the
    operands split into TF32 terms, each k step of 8 adding lo_a.hi_b,
    hi_a.lo_b and hi_a.hi_b (``terms`` 1: hi_a.hi_b alone) to the fp32
    accumulator in turn."""
    k = a.shape[-1]
    pad = -k % 8
    a = torch.nn.functional.pad(a.float(), (0, pad))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for c in range(0, k + pad, 8):
        step = slice(c, c + 8)
        if terms == 3:
            acc = acc + al[..., step] @ bh[..., step, :]
            acc = acc + ah[..., step] @ bl[..., step, :]
        acc = acc + ah[..., step] @ bh[..., step, :]
    return acc


def _probs_ds(q, k, v, do, lse, delta, scale, causal, window, slopes,
              terms):
    s = mma_product(q, k.transpose(-1, -2), terms) * scale
    if slopes is not None:
        s = s + fmha._alibi(slopes, s.shape[-1], s.device)
    live = fmha._visible(s.shape[-2], s.shape[-1], causal, window, s.device)
    p = torch.exp(s.masked_fill(~live, fmha.NEG_INF) - lse[..., None])
    dp = mma_product(do, v.transpose(-1, -2), terms)
    return p, p * (dp - delta[..., None])


def mma_bwd_model(q, k, v, do, lse, delta, scale, causal, window=None,
                  slopes=None, terms=3):
    """(dq, dk, dv) in q's dtype as the tensor-core kernels compute them:
    S and dP from split products, p and ds elementwise in fp32, then the
    second products of split p and ds; the scale multiplies the summed dq
    and dk."""
    p, ds = _probs_ds(q, k, v, do, lse, delta, scale, causal, window,
                      slopes, terms)
    dq = mma_product(ds, k, terms) * scale
    dk = mma_product(ds.transpose(-1, -2), q, terms) * scale
    dv = mma_product(p.transpose(-1, -2), do, terms)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def test_tf32_rounds_to_nearest_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 fraction bits
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      -(1 + ulp / 2), 1 + 3 * ulp / 2, 3.0e-3],
                     dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp,
                         float(np.float32(3.0e-3))], dtype=torch.float32)
    assert torch.equal(got[:5], want[:5])
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo leaves under 2**-21 of each value
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert ((y - hi - lo).abs() <= y.abs() * 2.0 ** -21).all()


# (causal, window, alibi, (block_q, block_k) of JAX's kernels, s, dtype);
# d = 64, one batch row of two heads
CASES = [
    (True, None, False, (64, 64), 256, "float32"),
    (True, 37, False, (64, 64), 256, "float32"),
    (True, None, True, (40, 40), 200, "float32"),
    (False, None, True, (40, 40), 200, "float32"),
    (True, None, False, (64, 64), 256, "bfloat16"),
    (True, 37, True, (40, 40), 200, "bfloat16"),
]
IDS = [f"{'causal' if c else 'full'}-w{w}-{'alibi' if a else 'noalibi'}-"
       f"s{s}-{dt}" for c, w, a, _, s, dt in CASES]
D = 64


def _inputs(case):
    causal, window, alibi, _, s, dtype = case
    rng = np.random.RandomState(3 * s + (window or 0) + 5 * alibi + causal)
    arrays = [rng.randn(1, 2, s, D).astype(np.float32) for _ in range(4)]
    slopes = (rng.uniform(0.01, 0.2, size=2).astype(np.float32) if alibi
              else None)
    return arrays, slopes


@functools.lru_cache(maxsize=None)
def _jax(case):
    """JAX's o and lse (forward kernel) and dq, dk, dv (backward kernels,
    from that o and lse), as fp32 numpy arrays."""
    causal, window, _, (bq, bk), _, dtype = case
    (q, k, v, do), slopes = _inputs(case)
    jq, jk, jv, jdo = (jnp.asarray(a, _JAX[dtype]) for a in (q, k, v, do))
    jsl = None if slopes is None else jnp.asarray(slopes)
    scale = 1.0 / np.sqrt(D)
    o, lse = jax_fmha._flash_fwd_pallas(jq, jk, jv, scale, causal, bq, bk,
                                        window, jsl)
    grads = jax_fmha._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, scale,
                                       causal, bq, bk, window, jsl)
    f32 = functools.partial(np.array, dtype=np.float32)
    return (f32(o.astype(jnp.float32)), f32(lse),
            [f32(g.astype(jnp.float32)) for g in grads])


def _model_args(case):
    """The model's inputs: the case's q, k, v, do in its dtype, and JAX's
    o (for delta, as the port's flash_bwd takes it) and lse."""
    causal, window, _, _, _, dtype = case
    (q, k, v, do), slopes = _inputs(case)
    o, lse, _ = _jax(case)
    dt = _TORCH[dtype]
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in (q, k, v, do))
    o = torch.from_numpy(o).to(dt)
    delta = fmha._delta(o, do)
    return (q, k, v, do, torch.from_numpy(lse), delta, 1.0 / np.sqrt(D),
            causal, window,
            None if slopes is None else torch.from_numpy(slopes))


def _outside(got, want, dtype):
    """The largest |got - want| as a share of the tolerance (> 1: out)."""
    rtol, scaled_atol = _TOL[dtype]
    atol = max(scaled_atol * np.abs(want).max(), ATOL_FLOOR)
    err = np.abs(got.float().numpy() - want)
    return float((err / (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_matches_jax_kernels(case):
    got = mma_bwd_model(*_model_args(case))
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax(case)[2]):
        assert g.dtype == _TORCH[case[-1]] and g.shape == w.shape
        assert _outside(g, w, case[-1]) <= 1.0, name


def test_single_term_model_fails():
    """Plain TF32 (hi terms only) reads past the tolerance on the fp32
    cases, where the three-term model holds."""
    readings = []
    for case in CASES:
        if case[-1] != "float32":
            continue
        got = mma_bwd_model(*_model_args(case), terms=1)
        readings.append(max(_outside(g, w, "float32")
                            for g, w in zip(got, _jax(case)[2])))
    assert max(readings) > 1.0, readings
    assert sum(r > 1.0 for r in readings) >= len(readings) // 2, readings


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_matches_the_plain_versions(case):
    """The model and the port's plain versions (the card's yardstick, fp32
    matmuls) agree within the same tolerance."""
    args = _model_args(case)
    got = mma_bwd_model(*args)
    want = (fmha.flash_dq_plain(*args), *fmha.flash_dkv_plain(*args))
    for g, w in zip(got, want):
        assert _outside(g, w.float().numpy(), case[-1]) <= 1.0
