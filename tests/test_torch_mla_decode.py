"""apex_tpu_torch.contrib.mla_decode (the MLA latent decode's plain
version, which the wrapper takes for CPU tensors) against apex_tpu's
Pallas kernel in interpret mode on the CPU, the tile ladder that
decides the model's branch, and the tensor-core body's plan, split rule
and a PyTorch model of its arithmetic (also held to the interpreted
kernel).

Inputs come from numpy seeds. Tolerance: 2e-6 absolute, as the JAX
package's own kernel tests (fp32 scores, softmax and sums in another
order; unit-scale inputs, outputs convex combinations of cache rows).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import mla_decode as jax_md
from apex_tpu.kernels.registry import choose_block as jax_choose_block
from apex_tpu_torch.contrib import mla_decode
from apex_tpu_torch.kernels import registry
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    jax_md.force_interpret(True)
    yield
    jax_md.force_interpret(False)


def _inputs(seed, b, n, L, T, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, L).astype(np.float32)
    cache = rng.randn(T, b, L).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ((jnp.asarray(q, jd), jnp.asarray(cache, jd)),
            (torch.from_numpy(q).to(td), torch.from_numpy(cache).to(td)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("length", [1, 7, 16, 33, 48])
def test_plain_version_matches_the_interpreted_kernel(length, dtype):
    b, n, lat, rope, T = 2, 8, 32, 8, 48
    (qj, cj), (qt, ct) = _inputs(length, b, n, lat + rope, T, dtype)
    want = jax_md.mla_flash_decode(qj, cj, jnp.int32(length), lat, 0.3,
                                   block_t=16)
    got = mla_decode.mla_flash_decode(qt, ct, length, lat, 0.3)
    assert got.dtype == torch.float32 and got.shape == (b, n, lat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dead_rows_are_invisible(dtype):
    """Rows at or past ``length`` holding 1e4 leave the result as it is."""
    b, n, lat, T, length = 2, 4, 16, 32, 10
    (qj, cj), (qt, ct) = _inputs(5, b, n, lat + 4, T, dtype)
    poisoned = ct.clone()
    poisoned[length:] = 1e4
    want = jax_md.mla_flash_decode(qj, cj.at[length:].set(1e4),
                                   jnp.int32(length), lat, 0.5, block_t=8)
    got = mla_decode.mla_flash_decode(qt, poisoned, length, lat, 0.5)
    clean = mla_decode.mla_flash_decode(qt, ct, length, lat, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), rtol=0,
                               atol=2e-6)


def test_per_row_lengths_are_each_rows_own():
    """A [b] length tensor gives each row what its own host length gives."""
    (_, _), (qt, ct) = _inputs(6, 3, 4, 24, 40, "float32")
    lengths = torch.tensor([1, 17, 40])
    got = mla_decode.mla_flash_decode(qt, ct, lengths, 16, 0.2)
    for r, n in enumerate(lengths.tolist()):
        want = mla_decode.mla_flash_decode(qt[r:r + 1], ct[:, r:r + 1], n,
                                           16, 0.2)
        torch.testing.assert_close(got[r:r + 1], want, rtol=0, atol=0)


@pytest.mark.parametrize("length", [0, -1, "row0", "scalar0"])
def test_a_length_below_one_is_refused_on_every_device(length):
    """With no live row the kernel (as JAX's) writes 0 and the plain version
    averages the whole buffer: the wrapper takes neither."""
    (_, _), (qt, ct) = _inputs(5, 2, 4, 24, 16, "float32")
    if length == "row0":
        length = torch.tensor([0, 3], dtype=torch.int32)
    elif length == "scalar0":
        length = torch.tensor(0)
    registry.reset()
    with pytest.raises(ValueError, match="must be >= 1"):
        mla_decode.mla_flash_decode(qt, ct, length, 16, 0.2)
    assert registry.launches()["mla_decode"] == 0


@pytest.mark.parametrize("cache_len", [40, 512, 600, 1280, 4608, 4100])
def test_tile_ladder_matches_jax(cache_len):
    assert (mla_decode.choose_block(cache_len, 512)
            == jax_choose_block(cache_len, 512))
    assert mla_decode.use_flash(cache_len) == jax_md.use_flash(cache_len)


def test_cpu_tensors_count_no_launch():
    (_, _), (qt, ct) = _inputs(7, 1, 2, 12, 8, "float32")
    registry.reset()
    mla_decode.mla_flash_decode(qt, ct, 3, 8, 0.4)
    assert registry.launches()["mla_decode"] == 0


def test_split_rows_fill_the_card_in_whole_tiles():
    """The path's step (b 8, 16 heads, a 4608-row cache on 132 SMs): 32
    chunks of 144 rows, 256 blocks; a chunk is whole tiles and the chunks
    cover the cache."""
    assert mla_decode.split_rows(4608, 8, 16, 132) == (144, 32)
    for T, b, n in ((1, 1, 1), (1024, 8, 16), (600, 2, 128), (4608, 1, 16)):
        chunk, splits = mla_decode.split_rows(T, b, n, 132)
        assert chunk % mla_decode.ROWS_PER_TILE == 0
        assert chunk * splits >= T > chunk * (splits - 1)


# ----------------------------------------------------------------------
# The tensor-core body (csrc/mla_decode.cu `mma_mla_decode`): its plan,
# its split rule, its constants and a PyTorch model of its arithmetic.

_CU = Path(mla_decode.__file__).resolve().parent.parent / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


def _plan(T=4608, q=BF16, c=BF16, aligned=True, L=576, lat=512, b=8, n=16):
    return mla_decode.mla_plan(b, n, L, lat, T, q, c, aligned, 132)


@pytest.mark.parametrize("T", [4608, 1024])
def test_plan_takes_the_tensor_cores_at_the_path_shapes(T):
    """bench.py mla_decode's [4608, 8, 576] and DeepSeek-V2-Lite's [1024,
    8, 576] bf16 caches with bf16 queries: the tensor-core body, its
    shared memory within a block's share, S splits that fill the card."""
    plan = _plan(T)
    assert plan.path == mla_decode.TENSOR_CORES
    assert plan.keys == mla_decode.STAGE_KEYS and plan.chunk == 0
    assert plan.min_steps == mla_decode.MIN_SPLIT_STEPS
    assert 1 < plan.splits <= mla_decode.MAX_SPLITS
    assert mla_decode.MAX_SPLITS <= mla_decode.KERNEL_MAX_SPLITS
    assert mla_decode.shared_bytes(576) <= mla_decode.MAX_SHARED


@pytest.mark.parametrize("case", [
    dict(q=F32), dict(c=F32), dict(q=F32, c=F32), dict(aligned=False),
    dict(L=1024, lat=576), dict(L=64, lat=32), dict(L=608, lat=512),
    dict(L=576, lat=256)])
def test_plan_keeps_the_first_design_off_the_path(case):
    """fp32 q or cache (the JAX package's fp32 end-to-end tests), q or
    cache off a 16-byte boundary, lat over 512 or another latent width
    than DeepSeek's 512, L not a multiple of 64: the first design, cut by
    split_rows."""
    plan = _plan(**case)
    assert plan.path == mla_decode.FIRST_DESIGN
    L = case.get("L", 576)
    assert (plan.chunk, plan.splits) == mla_decode.split_rows(4608, 8, 16,
                                                              132)
    assert plan.keys == plan.min_steps == 0 and L


@pytest.mark.parametrize("L", [576, 1024])
def test_plan_takes_the_tensor_cores_only_where_the_stages_fit(L):
    """Rows whose Q, stages and P planes overflow a block's shared memory
    keep the first design."""
    fits = mla_decode.shared_bytes(L) <= mla_decode.MAX_SHARED
    assert (_plan(L=L).path == mla_decode.TENSOR_CORES) == fits
    assert mla_decode.shared_bytes(1024) > mla_decode.MAX_SHARED


def test_plan_fills_the_card_and_no_more():
    """S = 1 once the (batch row, head group) cells alone fill the blocks
    the card holds; 128 heads make 8 groups a row."""
    resident = (mla_decode.SM_SHARED
                // (mla_decode.shared_bytes(576) + 1024)) * 132
    assert _plan(b=resident).splits == 1
    assert _plan(b=2, n=128).splits == min(mla_decode.MAX_SPLITS,
                                           -(-resident // 16))


@pytest.mark.parametrize("length", [1, 15, 16, 17, 528, 4129, 4608])
def test_splits_follow_the_live_length(length):
    """A row's live range (1, 528 and 4129 of a 4608-row buffer, and the
    step edges) is cut into whole 16-key steps, one split for every
    min_steps of them and at most the grid's S: the used splits cover
    [0, length) once, in order, and the rest are empty."""
    plan = _plan()
    used = mla_decode.used_splits(length, plan.splits, plan.min_steps)
    steps = -(-length // 16)
    assert 1 <= used <= plan.splits
    assert used == max(1, min(plan.splits, steps // plan.min_steps))
    parts = [mla_decode.split_keys(length, s, plan.splits, plan.min_steps)
             for s in range(plan.splits)]
    live = [p for p in parts if p[1] > p[0]]
    assert len(live) == used and parts[used:] == [(0, 0)] * (plan.splits
                                                             - used)
    assert live[0][0] == 0 and live[-1][1] == length
    for (_, a1), (b0, _) in zip(live, live[1:]):
        assert a1 == b0 and a1 % 16 == 0
    if used > 1:
        assert all(-(-(hi - lo) // 16) >= plan.min_steps for lo, hi in live)
    if length == 1:
        assert used == 1


def test_tensor_core_constants_match_the_kernel_source():
    """The plan's mirror of the source: the stage shape, the grid's split
    limit, the shared-memory formula and limit, the merge tree's counters,
    the path codes, and the launch conditions of the tensor-core body."""
    src = (_CU / "mla_decode.cu").read_text()
    assert "constexpr int kWarps = 8;" in src
    assert "constexpr int kKeys = 8 * kWarps;" in src
    assert mla_decode.STAGE_KEYS == 64
    assert f"constexpr int kStages = {mla_decode.STAGES};" in src
    assert (f"constexpr int kMmaMaxSplits = {mla_decode.KERNEL_MAX_SPLITS};"
            in src)
    assert (f"constexpr int kCountersPerCell = "
            f"{mla_decode.COUNTERS_PER_CELL};" in src)
    assert "constexpr size_t kMaxDynamicShared = 232448 - 2048;" in src
    assert mla_decode.MAX_SHARED == 232448 - 2048
    assert "constexpr int kPld = kKeys + 8;" in src
    assert re.search(r"return 2 \* \(static_cast<size_t>\(16 \+ kStages "
                     r"\* kKeys\) \* mma_ld\(L\) \+\s+3 \* 16 \* kPld\);", src)
    assert "__host__ __device__ constexpr int mma_ld(int L) { return L + 8; }" \
        in src
    assert f"constexpr int kPathTensor = {mla_decode.TENSOR_CORES};" in src
    assert "constexpr int kDropLastSplit = 2;" in src
    assert "constexpr int kNoRope = 3;" in src
    assert "constexpr int kLat = 512;" in src and mla_decode.TENSOR_LAT == 512
    assert re.search(r"L % 64 \|\| lat != kLat \|\| L < lat", src)
    assert re.search(r"steps / a\.min_steps", src)
    # the tree: fan-in 4, its nodes fewer than 2 S a cell, its counters
    # 16 + 4 + 1 at the kernel's 64 splits
    assert "const int first = node & ~3, members = min(4, width - first);" \
        in src
    nodes, ctrs, width = 0, 0, mla_decode.KERNEL_MAX_SPLITS
    while width > 1:
        nodes, ctrs, width = nodes + width, ctrs + -(-width // 4), -(-width // 4)
    assert nodes < 2 * mla_decode.KERNEL_MAX_SPLITS
    assert ctrs <= mla_decode.COUNTERS_PER_CELL


_LOG2E = torch.tensor(1.4426950408889634, dtype=F32)


def _split3(p):
    """p (fp32) as three bf16 terms, each the rounding of what the ones
    before it left (apex_kv::split3)."""
    hi = p.to(BF16).float()
    r = p - hi
    mid = r.to(BF16).float()
    return hi, mid, (r - mid).to(BF16).float()


def _tree(parts):
    """Merge (m, l, acc) partials as the kernel's tree does: groups of 4
    consecutive nodes, each merged in index order with weights exp2((m_i
    - max m) log2 e), level by level; a lone node moves up as it is."""
    while len(parts) > 1:
        up = []
        for g in range(0, len(parts), 4):
            group = parts[g:g + 4]
            if len(group) == 1:
                up.append(group[0])
                continue
            top = torch.stack([m for m, _, _ in group]).max(0).values
            den, num = torch.zeros_like(top), torch.zeros_like(group[0][2])
            for m, l, acc in group:
                w = torch.exp2((m - top) * _LOG2E)
                den = den + w * l
                num = num + w[:, None] * acc
            up.append((top, den, num))
        parts = up
    return parts[0]


def _model(q, cache, lengths, lat, scale, keys, splits, min_steps):
    """mma_mla_decode's arithmetic in fp32 on the CPU: bf16 products
    summed in fp32, then the scale; an online softmax over stages of
    ``keys`` rows with exp2(x log2 e); P as three bf16 terms, each times
    the values summed in fp32 into the accumulator, smallest first; the
    splits' (m, l, acc) merged by the kernel's tree."""
    b, n, L = q.shape
    out = torch.zeros(b, n, lat)
    for bi in range(b):
        live = min(int(lengths[bi]), cache.shape[0])
        parts = []
        for s in range(mla_decode.used_splits(live, splits, min_steps)):
            lo, hi = mla_decode.split_keys(live, s, splits, min_steps)
            m = torch.full((n,), -1e30)
            l = torch.zeros(n)
            acc = torch.zeros(n, lat)
            for t0 in range(lo, hi, keys):
                rows = cache[t0:min(t0 + keys, hi), bi].float()
                x = (q[bi].float() @ rows.T) * scale
                m_new = torch.maximum(m, x.max(1).values)
                alpha = torch.exp2((m - m_new) * _LOG2E)
                p = torch.exp2((x - m_new[:, None]) * _LOG2E)
                l = alpha * l + p.sum(1)
                acc = acc * alpha[:, None]
                for term in reversed(_split3(p)):
                    acc = acc + term @ rows[:, :lat]
                m = m_new
            parts.append((m, l, acc))
        _, l, acc = _tree(parts)
        out[bi] = acc / l.clamp_min(1e-30)[:, None]
    return out


@pytest.fixture(scope="module")
def _small_case():
    """b 2, 16 heads, L 576 (lat 512 + rope 64), T 128, bf16; JAX's
    interpreted kernel at lengths 1 and 100 (two interpret-mode runs)."""
    jax_md.force_interpret(True)
    try:
        (qj, cj), (qt, ct) = _inputs(17, 2, 16, 576, 128, "bfloat16")
        want = {n: torch.from_numpy(np.array(jax_md.mla_flash_decode(
            qj, cj, jnp.int32(n), 512, 0.05, block_t=32))) for n in (1, 100)}
    finally:
        jax_md.force_interpret(False)
    return qt, ct, want


@pytest.mark.parametrize("keys,splits,min_steps", [
    (mla_decode.STAGE_KEYS, 1, 1), (mla_decode.STAGE_KEYS, 4, 1),
    (mla_decode.STAGE_KEYS, 16, 1),
    (mla_decode.STAGE_KEYS, 16, mla_decode.MIN_SPLIT_STEPS)])
def test_model_of_the_tensor_core_body_matches_jax(_small_case, keys, splits,
                                                   min_steps):
    """The model unsplit, with one tree level (4 splits) and two (7
    splits at length 100), against JAX's interpreted _decode_kernel at
    one length for every row (2e-6, as above), and against the plain
    version with each row at its own length."""
    qt, ct, want = _small_case
    assert mla_decode.mla_plan(2, 16, 576, 512, 128, BF16, BF16, True,
                               132).path == mla_decode.TENSOR_CORES
    for n, w in want.items():
        got = _model(qt, ct, [n, n], 512, 0.05, keys, splits, min_steps)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=2e-6)
    rows = torch.tensor([1, 100])
    got = _model(qt, ct, rows, 512, 0.05, keys, splits, min_steps)
    ref = mla_decode.mla_decode_reference(qt, ct, rows, 512, 0.05)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-6)
