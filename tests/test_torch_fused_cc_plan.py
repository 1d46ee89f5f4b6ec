"""The launch plan of the TP GEMM #20 (``apex_tpu_torch.kernels.fused_cc``
``plan``, ``mm_launch``) and a PyTorch model of its split-K arithmetic
(``csrc/fused_cc_matmul.cu``), on the CPU.

The plan picks a block tile and a split count S of K from (m, n, k) and
the SM count alone; the tests hold the plans at the row-parallel tiles of
the ``tp_dp`` and ``tp_gpt2`` paths, that the blocks fill the card where
K allows, that the splits cut K into contiguous whole steps, each split
at least one, and that the launch passes the same plan for every dtype
pair (a bf16 output must round the same fp32 sum as an fp32 one).

The model repeats the kernel's order: split s sums its K range in
increasing k, one fused multiply-add a step (emulated in float64, where
an fp32 product is exact, and rounded to fp32 a step), and the S fp32
partials are added in split order. It is held against JAX's Pallas
``_mm_kernel`` in interpret mode within 1e-6 of |x| @ |w| per element
(``chip_smoke.py`` TP_MATMUL_TOL: two fp32 sums of the same products in
different orders).
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu_torch.kernels import _checks, fused_cc, kv_attention
from torch_threads import one_torch_thread  # noqa: F401

SMS = 132  # an H100 SXM
TOL = 1e-6
_SOURCE = (Path(fused_cc.__file__).resolve().parent.parent / "csrc"
           / "fused_cc_matmul.cu")


@pytest.fixture
def interpret():
    kreg = get_kernel_registry()
    kreg.force_interpret(True)
    try:
        yield
    finally:
        kreg.force_interpret(False)


# ------------------------------------------------------------- the plan

# (m, n, k) of each path tile -> (bm, bn, splits): tp_gpt2's MLP and
# attention wo tiles (8 x 1024 rows, a 256-column tile of wo), tp_dp's
PATH_PLANS = [
    ((8192, 256, 4096), (128, 64, 1)),
    ((8192, 256, 1024), (128, 64, 1)),
    ((128, 64, 1024), (64, 64, 16)),
    ((128, 64, 256), (64, 64, 8)),
]


@pytest.mark.parametrize("shape,want", PATH_PLANS)
def test_plan_at_the_path_tiles(shape, want):
    assert fused_cc.plan(*shape, SMS) == want


SHAPES = [(m, n, k) for m in (1, 13, 128, 300, 1024, 8192)
          for n in (1, 64, 100, 256, 1024)
          for k in (1, 31, 32, 256, 1000, 1024, 4096)]


def split_range(k, split, splits):
    """The K range [lo, hi) of split ``split`` of ``splits`` as the kernel
    cuts it: the ceil(k / MM_STEP) steps cut at split * steps // S."""
    steps = -(-k // fused_cc.MM_STEP)
    return (fused_cc.MM_STEP * (steps * split // splits),
            min(k, fused_cc.MM_STEP * (steps * (split + 1) // splits)))


def test_plan_constants_match_the_kernel_source():
    """The plan mirrors csrc/fused_cc_matmul.cu: the K step, the most
    splits, the split rule and the tiles the C function takes."""
    src = _SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kBK") == fused_cc.MM_STEP
    assert const("kMaxSplits") == fused_cc.MM_MAX_SPLITS
    assert "static_cast<long long>(steps_all) * split / S" in src
    for bm, bn in fused_cc.MM_TILES:
        assert f"if (bm == {bm} && bn == {bn})" in src


def _tiles(m, n, tile):
    return -(-m // tile[0]) * -(-n // tile[1])


def test_plan_fills_the_card_where_k_allows():
    """Every plan takes a tile of MM_TILES and 1 .. MM_MAX_SPLITS splits,
    none past the K steps. The largest tile whose tiles fill one wave (a
    block an SM) runs unsplit; where no tile does, the smallest splits K
    into the S nearest to two blocks an SM (tiles x S within half a tile
    of 2 x sms) unless K's steps or MM_MAX_SPLITS cap it: the blocks fill
    the card wherever K allows."""
    for m, n, k in SHAPES:
        bm, bn, s = fused_cc.plan(m, n, k, SMS)
        assert (bm, bn) in fused_cc.MM_TILES
        steps = -(-k // fused_cc.MM_STEP)
        most = min(fused_cc.MM_MAX_SPLITS, steps)
        assert 1 <= s <= most
        tiles = _tiles(m, n, (bm, bn))
        larger = fused_cc.MM_TILES[:fused_cc.MM_TILES.index((bm, bn))]
        assert all(_tiles(m, n, t) < SMS for t in larger), (m, n, k)
        if tiles >= SMS:
            assert s == 1
            continue
        assert (bm, bn) == fused_cc.MM_TILES[-1]
        assert 2 * tiles * s <= 4 * SMS + tiles, (m, n, k)
        if s < most:
            assert 2 * tiles * s >= 4 * SMS - tiles, (m, n, k)
            assert tiles * s >= SMS


def test_splits_cut_k_into_whole_steps():
    """The splits' K ranges are contiguous, cover [0, k) once, start on a
    K step and each holds at least one step."""
    for m, n, k in SHAPES:
        s = fused_cc.plan(m, n, k, SMS)[2]
        ranges = [split_range(k, i, s) for i in range(s)]
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2
        for lo, hi in ranges:
            assert lo % fused_cc.MM_STEP == 0 and hi > lo


def test_launch_plan_is_the_same_for_every_dtype_pair(monkeypatch):
    """mm_launch hands the C function one plan (bm, bn, S) and one K per
    shape whatever the dtypes of x and w: the C function is replaced by
    a recorder, so this runs on CPU tensors."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fused_cc, "_mm_kernel", lambda: record)
    monkeypatch.setattr(kv_attention, "sm_count", lambda index: SMS)
    monkeypatch.setattr(kv_attention, "counters",
                        lambda device, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    for m, n, k in ((128, 64, 1024), (128, 64, 256), (13, 64, 256)):
        plans = set()
        for tx in (torch.float32, torch.bfloat16):
            for tw in (torch.float32, torch.bfloat16):
                x = torch.zeros(m, k, dtype=tx)
                w = torch.zeros(k, 4 * n, dtype=tw)[:, n:2 * n]
                out = torch.empty(m, n, dtype=torch.result_type(x, w))
                fused_cc.mm_launch(x, w, out, k)
                args = calls.pop()
                assert args[8:10] == (_checks.DTYPE_CODES[tx],
                                      _checks.DTYPE_CODES[tw])
                assert args[6:8] == (k, 4 * n)  # lda, ldw: w read in place
                plans.add((args[3:6], args[10:13]))
                assert (args[13] is None) == (args[12] == 1)
        assert plans == {((m, n, k), fused_cc.plan(m, n, k, SMS))}


# ---------------------------------------------- the split-K arithmetic

def split_k_model(x, w, sms=SMS):
    """x [m, k] @ w [k, n] as #20 sums it on a card of ``sms`` SMs: each
    split's fp32 partial over its K range in increasing k, one fused
    multiply-add a step (float64 holds the fp32 product exactly; one
    rounding to fp32 a step), the partials added in split order."""
    m, k = x.shape
    n = w.shape[1]
    s = fused_cc.plan(m, n, k, sms)[2]
    xd, wd = x.double(), w.double()
    total = None
    for i in range(s):
        lo, hi = split_range(k, i, s)
        acc = torch.zeros(m, n, dtype=torch.float32)
        for kk in range(lo, hi):
            acc = (acc.double() + xd[:, kk:kk + 1] * wd[kk:kk + 1]).float()
        total = acc if total is None else total + acc
    return total


MODEL_CASES = [(13, 256, 64), (128, 1024, 64), (128, 256, 64),
               (40, 1000, 48)]


@pytest.mark.parametrize("m,k,n", MODEL_CASES)
@pytest.mark.parametrize("tx,tw", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_split_k_model_matches_jax_interpret(interpret, m, k, n, tx, tw):
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    xt, wt = torch.from_numpy(x).to(dt[tx]), torch.from_numpy(w).to(dt[tw])
    want = np.asarray(jax_fused_cc._matmul(jnp.asarray(x, jt[tx]),
                                           jnp.asarray(w, jt[tw])))
    got = split_k_model(xt, wt).numpy()
    assert fused_cc.plan(m, n, k, SMS)[2] > 1  # the split path
    mag = torch.matmul(xt.float().abs(), wt.float().abs()).numpy()
    assert want.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got - want) <= TOL * mag).all(), \
        np.max(np.abs(got - want) / mag)


def test_split_k_model_bf16_output_rounds_the_fp32_sum(interpret):
    """bf16 x and w: the output is the fp32 sum rounded to bf16, within
    one bf16 rounding of JAX's (two fp32 sums in different orders may
    round to neighbouring bf16 values)."""
    rng = np.random.RandomState(5)
    x = rng.randn(13, 256).astype(np.float32)
    w = (rng.randn(256, 64) / 16).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    want = np.asarray(jax_fused_cc._matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ).astype(jnp.float32))
    got = split_k_model(xt, wt).bfloat16().float().numpy()
    mag = torch.matmul(xt.float().abs(), wt.float().abs()).numpy()
    assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + TOL * mag).all()
