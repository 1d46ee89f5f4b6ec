"""The split plan and the arithmetic of the KV-cache attention kernels #21
and #25 (apex_tpu_torch/csrc/kv_attention.cuh), on the CPU.

The kernels run only on the card. What is tested here:

* the launch plan (``kernels/kv_attention.py``): the number of splits S
  from the shapes and the SM count, and the kernel's own rule for cutting
  a row tile's live key range into S parts of whole 16-key steps: every
  visible key lies in exactly one split;
* a model of the kernel's arithmetic in PyTorch (test-only): the same
  plan, each warp's online softmax updated once a 16-key step with P
  split into three bf16 terms for P.V, the warps and then the splits
  merged in index order. It is held to JAX's ``gqa_flash_decode`` and ``window_attention``
  (Pallas kernels in interpret mode) at TinyLlama's widths (b 8, g 4, rep
  8, d 64, a 2048-row cache) within ATTN_TOL = 1e-4, the limit the chip
  checks hold the kernels to against their plain versions (fp32 scores,
  softmax and sums in another order, outputs of magnitude ~1). The same
  model with P rounded once to bf16 reads above that limit, and with P as
  two terms (hi + lo) well above the plain version's fp32 error: the
  reasons for the three-term split.

Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu_torch.kernels import fused_cc
from apex_tpu_torch.kernels import kv_attention as kv
from torch_threads import one_torch_thread  # noqa: F401

ATTN_TOL = 1e-4
H100_SMS = 132
B, G, REP, D, T = 8, 4, 8, 64, 2048   # TinyLlama-1.1B's serving shapes
NEG_INF = -1e30


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc"])
    jax_gqa.force_interpret(True)
    yield
    jax_gqa.force_interpret(False)
    reg.force_interpret(False, ["fused_cc"])


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("n_rows,cells,want", [
    (8, 32, (1, 16)),       # decode, b 8: 32 cells -> 512 blocks
    (8, 8, (1, 16)),        # decode, b 2: capped at MAX_SPLITS
    (40, 32, (3, 6)),       # speculative verify, w 5
    (256, 8, (16, 5)),      # smallest prefill bucket, w 32, b 2
    (512, 16, (32, 1)),     # w 64, b 4: the row tiles fill the card
    (1024, 32, (64, 1)),    # generate's prefill: 2048 blocks
    (8, 512, (1, 1)),       # a decode batch that fills the card alone
])
def test_plan_covers_the_card(n_rows, cells, want):
    assert kv.plan(n_rows, cells, H100_SMS) == want


@pytest.mark.parametrize("cells", [132, 264, 265, 512, 4096])
def test_one_split_once_the_row_tiles_fill_the_card(cells):
    for n_rows in (8, 40, 1024):
        tiles, splits = kv.plan(n_rows, cells, H100_SMS)
        if cells * tiles >= 2 * H100_SMS:
            assert splits == 1
        assert 1 <= splits <= kv.MAX_SPLITS
        assert kv.ROWS * tiles >= n_rows > kv.ROWS * (tiles - 1)


def _assert_partition(t_lo, t_hi, splits):
    """Every key of [t_lo, t_hi] in exactly one split. The range uses its
    first S' = used_splits of the grid's splits (one for every
    MIN_SPLIT_STEPS steps, at least one), each a run of whole 16-key steps
    from t_lo (but the range's last), sizes within one step of each other;
    the others are empty."""
    steps = max(0, -(-(t_hi - t_lo + 1) // kv.STEP))
    used = kv.used_splits(t_lo, t_hi, splits)
    assert used == max(1, min(splits, steps // kv.MIN_SPLIT_STEPS))
    seen, sizes = [], []
    for s in range(splits):
        lo, hi = kv.split_keys(t_lo, t_hi, s, splits)
        if s >= used:
            assert lo >= hi
            continue
        assert (lo - t_lo) % kv.STEP == 0
        if hi <= t_hi:
            assert (hi - t_lo) % kv.STEP == 0
        seen.extend(range(lo, hi))
        sizes.append(-(-(hi - lo) // kv.STEP) if hi > lo else 0)
    assert seen == list(range(t_lo, t_hi + 1))
    assert max(sizes) - min(sizes) <= 1
    if used > 1:
        assert min(sizes) >= kv.MIN_SPLIT_STEPS


@pytest.mark.parametrize("t_lo,t_hi,splits", [
    (0, -1, 1), (0, -1, 8),          # empty range: every part empty
    (5, 5, 1), (5, 5, 16),           # one key: one part holds it
    (0, 15, 8), (0, 16, 8), (3, 35, 2),
    (0, 143, 8), (0, 143, 16),       # decode at length 144: unsplit
    (0, 127, 16), (0, 255, 16), (0, 383, 16),  # one, two, three parts
    (0, 2047, 8), (0, 2047, 16), (1, 2046, 3),
])
def test_split_keys_partitions_the_live_range(t_lo, t_hi, splits):
    _assert_partition(t_lo, t_hi, splits)


@pytest.mark.parametrize("w,window,starts", [
    (1, None, (0, 2047)),             # decode at both ends of the cache
    (1, 50, (0, 49, 50, 2047)),
    (5, None, (0, 1000, 2043)),       # verify window, ends of the cache
    (5, 17, (0, 3, 2043)),
    (128, None, (0, 1920)),           # a prefill chunk
    (128, 50, (0, 1920)),
])
def test_every_visible_key_is_read_by_one_split(w, window, starts):
    """Through the kernel's plan: each query row's visible keys lie in its
    row tile's live range, and the tile's splits read each of them once."""
    n_rows = w * REP
    rows = kv.ROWS
    tiles, _ = kv.plan(n_rows, B * G, H100_SMS)
    for start in starts:
        for splits in (1, 3, 8, 16):
            for tile in range(tiles):
                row0, row_end = tile * rows, min((tile + 1) * rows, n_rows)
                t_lo, t_hi = kv.live_range(start, row0, row_end, REP, window,
                                           T)
                _assert_partition(t_lo, t_hi, splits)
                for r in range(row0, row_end):
                    pos = start + r // REP
                    first = max(pos - window + 1, 0) if window else 0
                    assert t_lo <= first and min(pos, T - 1) <= t_hi


# ------------------------------------------- a model of the arithmetic

def _state(g, n, d):
    return [torch.full((g, n), NEG_INF), torch.zeros(g, n),
            torch.zeros(g, n, d)]


def _merge(parts):
    """Partial softmax states merged in index order, as the kernel does."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    e = [torch.exp(p[0] - m) for p in parts]
    l_sum = sum(ei * p[1] for ei, p in zip(e, parts))
    acc = sum(ei[..., None] * p[2] for ei, p in zip(e, parts))
    return [m, l_sum, acc]


def _step(st, qr, kk, vv, keys, pos, key_end, window, softcap, sm_scale,
          p_terms):
    """One update of a warp's online softmax over its 16-key step."""
    s = torch.einsum("grd,gkd->grk", qr, kk) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    masked = (keys[None, :] > pos[:, None]) | (keys[None, :] >= key_end)
    if window is not None:
        masked = masked | (pos[:, None] - keys[None, :] >= window)
    mx = s.masked_fill(masked, NEG_INF).amax(-1)
    m_new = torch.maximum(st[0], mx)
    alpha = torch.exp(st[0] - m_new)
    p = torch.exp(s - m_new[..., None]).masked_fill(masked, 0.0)
    pv, rest = 0.0, p
    for _ in range(p_terms):  # P as bf16 terms, each product summed in fp32
        term = rest.bfloat16().float()
        pv = pv + torch.einsum("grk,gkd->grd", term, vv)
        rest = rest - term
    st[1] = alpha * st[1] + p.sum(-1)
    st[2] = alpha[..., None] * st[2] + pv
    st[0] = m_new


def kernel_model(q, k, v, starts, start_bias, sm_scale, window=None,
                 softcap=None, splits=None, p_terms=3):
    """The kernel's arithmetic: q [w, b, g, rep, d], k/v [T, b, g, d]
    (bf16), starts [b] ints -> ctx [w, b, g, rep, d] fp32. Row tiles of
    16; warp w of a block takes step w of every 4-step stage of its split;
    the warps, then the splits, merge in index order. ``p_terms`` bf16
    terms of P (the kernel: 3; 1 rounds P once)."""
    w, b, g, rep, d = q.shape
    cache_len = k.shape[0]
    n_rows = w * rep
    tiles, planned = kv.plan(n_rows, b * g, H100_SMS)
    splits = splits or planned
    qf = q.float().permute(1, 2, 0, 3, 4).reshape(b, g, n_rows, d)
    kf = k.float().permute(1, 2, 0, 3)
    vf = v.float().permute(1, 2, 0, 3)
    out = torch.zeros(b, g, n_rows, d)
    for bi in range(b):
        start = int(starts[bi]) + start_bias
        for tile in range(tiles):
            row0, row_end = tile * kv.ROWS, min((tile + 1) * kv.ROWS, n_rows)
            r = torch.arange(row0, row_end)
            pos = start + r // rep
            t_lo, t_hi = kv.live_range(start, row0, row_end, rep, window,
                                       cache_len)
            parts = []
            for s in range(splits):
                lo, hi = kv.split_keys(t_lo, t_hi, s, splits)
                warps = [_state(g, len(r), d) for _ in range(4)]
                for i, k0 in enumerate(range(lo, hi, kv.STEP)):
                    keys = torch.arange(k0, k0 + kv.STEP)
                    rows_k = keys.clamp(max=cache_len - 1)
                    _step(warps[i % 4], qf[bi, :, r], kf[bi][:, rows_k],
                          vf[bi][:, rows_k], keys, pos, hi, window, softcap,
                          sm_scale, p_terms)
                parts.append(_merge(warps))
            m, l_sum, acc = _merge(parts)
            out[bi, :, r] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out.reshape(b, g, w, rep, d).permute(2, 0, 1, 3, 4)


def _inputs(seed, w):
    rng = np.random.RandomState(seed)
    q = rng.randn(w, B, G, REP, D).astype(np.float32)
    k = rng.randn(T, B, G, D).astype(np.float32)
    v = rng.randn(T, B, G, D).astype(np.float32)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tx = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    return jx, tx


def _decode_error(length, p_terms):
    (qj, kj, vj), (qt, kt, vt) = _inputs(length, 1)
    sm = D ** -0.5
    want = np.asarray(jax_gqa.gqa_flash_decode(qj[0], kj, vj, length, sm))
    got = kernel_model(qt, kt, vt, [length] * B, -1, sm, p_terms=p_terms)
    return np.abs(got[0].numpy() - want).max()


@pytest.mark.parametrize("length", [1, 144, 2048])
def test_model_of_decode_matches_jax(length):
    assert _decode_error(length, p_terms=3) <= ATTN_TOL


def test_p_rounded_once_to_bf16_misses_the_limit():
    """Why P.V does not take P rounded once to bf16: P is then off by up
    to 2**-9 of itself, and the output by more than ATTN_TOL."""
    assert _decode_error(144, p_terms=1) > ATTN_TOL


def test_three_bf16_terms_of_p_keep_fp32_accuracy():
    """Why three terms and not two: at the prefill (w 128, start 0),
    against an fp64 reference, P as hi + lo leaves the output more than
    five times as far off as the plain version's own fp32 arithmetic;
    hi + mid + lo stays within twice it."""
    (_, _, _), (qt, kt, vt) = _inputs(128, 128)
    sm = D ** -0.5
    s = torch.einsum("sbgrd,tbgd->bgrst", qt.double(), kt.double()) * sm
    causal = torch.arange(T)[None, :] > torch.arange(128)[:, None]
    p = torch.softmax(s.masked_fill(causal, NEG_INF), dim=-1)
    truth = torch.einsum("bgrst,tbgd->sbgrd", p, vt.double())
    plain = fused_cc.window_attention_plain(qt, kt, vt, 0, sm)

    def err(x):
        return (x.double() - truth).abs().max().item()

    two = err(kernel_model(qt, kt, vt, [0] * B, 0, sm, p_terms=2))
    three = err(kernel_model(qt, kt, vt, [0] * B, 0, sm, p_terms=3))
    assert two > 5 * err(plain)
    assert three <= 2 * err(plain)


def test_model_of_verify_window_at_mixed_starts_matches_jax():
    w = 5
    (qj, kj, vj), (qt, kt, vt) = _inputs(5, w)
    starts = np.random.RandomState(6).randint(0, T - w + 1, size=B)
    starts[0], starts[-1] = 0, T - w   # both ends of the cache
    sm = D ** -0.5
    got = kernel_model(qt, kt, vt, starts, 0, sm)
    for bi, start in enumerate(starts):  # JAX takes one start per call
        want = jax_fused_cc.window_attention(
            qj[:, bi:bi + 1], kj[:, bi:bi + 1], vj[:, bi:bi + 1],
            int(start), sm)
        np.testing.assert_allclose(got[:, bi:bi + 1].numpy(),
                                   np.asarray(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


def test_model_of_prefill_window_matches_jax():
    w = 128
    (qj, kj, vj), (qt, kt, vt) = _inputs(128, w)
    sm = D ** -0.5
    want = jax_fused_cc.window_attention(qj, kj, vj, 0, sm)
    got = kernel_model(qt, kt, vt, [0] * B, 0, sm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("splits", [1, 16])
def test_model_at_forced_splits_matches_jax_with_window_and_softcap(splits):
    """S = 1 and S = 16 (the chip checks' forced counts) with a sliding
    window and a softcap, at a mid-cache decode length."""
    length, window, cap = 777, 50, 30.0
    (qj, kj, vj), (qt, kt, vt) = _inputs(9, 1)
    sm = D ** -0.5
    want = np.asarray(jax_gqa.gqa_flash_decode(
        qj[0], kj, vj, length, sm, window=window, softcap=cap))
    got = kernel_model(qt, kt, vt, [length] * B, -1, sm, window=window,
                       softcap=cap, splits=splits)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
