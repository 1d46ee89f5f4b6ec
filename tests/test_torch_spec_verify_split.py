"""The int8-cache verify kernel #22's split body (apex_tpu_torch/csrc/
kv_attention.cuh with its Int8KV source, spec_verify.cu's path 1), on
the CPU.

The kernel runs only on the card. What is tested here:

* its plan (``kernels/fused_cc.py`` ``verify_plan``): the split
  tensor-core body for bf16 queries at head dim 64 or 128 where a cell's
  d lanes lie in one block of the store (B % d == 0) and the operands are
  16-byte aligned, the first design otherwise;
* a model of the body's arithmetic in PyTorch (test-only), on #21's plan
  (``kernels/kv_attention.py``: row tiles of 16, ``split_keys`` splits,
  a 16-key step a warp): the scores are (q . codes) * ks * sm_scale in
  fp32, the codes exact in bf16; P.V takes p * vs in fp32 split into
  three bf16 terms, each times the codes; the denominator is the sum of
  p; warps and then splits merge in index order. It is held to JAX's
  ``spec_verify_attention`` (the Pallas kernel in interpret mode, one
  slot a call) and to the port's ``spec_verify_reference`` at per-row
  starts and forced splits within ATTN_TOL = 1e-4, the limit the chip
  checks hold the kernel to (fp32 scores, softmax and sums in another
  order, outputs of magnitude ~1);
* the path codes of apex_spec_verify against the source.

Inputs come from numpy seeds: codes in [-127, 127] and positive scales,
the same values on both sides.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu_torch.kernels import fused_cc
from apex_tpu_torch.kernels import kv_attention as kv
from torch_threads import one_torch_thread  # noqa: F401

ATTN_TOL = 1e-4
H100_SMS = 132
NEG_INF = -1e30
_CSRC = Path(fused_cc.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc"])
    yield
    reg.force_interpret(False, ["fused_cc"])


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("d,block", [(64, 256), (128, 256), (64, 64),
                                     (64, 128), (128, 128), (64, 512)])
def test_plan_takes_the_split_body_for_bf16_over_whole_blocks(d, block):
    """The serving store (B = 256 over d 64 or 128) and any block a
    multiple of d: one scale a key row for every cell."""
    assert fused_cc.verify_plan(2, d, block, True) == fused_cc.VERIFY_SPLIT


@pytest.mark.parametrize("itemsize,d,block,aligned", [
    (4, 64, 256, True),    # fp32 queries
    (2, 64, 96, True),     # a cell's lanes cross a block (the smoke's 96)
    (2, 128, 64, True),    # a cell spans two blocks
    (2, 32, 256, True),    # a head dim without an instance
    (2, 64, 256, False)])  # q or the codes off a 16-byte boundary
def test_plan_keeps_the_first_design_elsewhere(itemsize, d, block, aligned):
    assert fused_cc.verify_plan(itemsize, d, block, aligned) == \
        fused_cc.VERIFY_FIRST_DESIGN


def test_path_codes_match_the_kernel_source():
    """apex_spec_verify: 0 the first design, 1 the split body, 2 its
    planted fault dropping the last live split from the merge, 3 the
    neighbour row's scale; the split body refuses fp32 queries and
    blocks that split a cell."""
    verify = (_CSRC / "spec_verify.cu").read_text()
    body = (_CSRC / "kv_attention.cuh").read_text()
    assert "if (path < 0 || path > 3) return -1;" in verify
    assert "if (dtype != 1) return -1;" in verify
    assert "return apex_kv::dispatch_int8(k, b * g, d, path," in verify
    assert "if (path == 1) return launch<Int8KV<D, false>, kNoFault>" in body
    assert ("if (path == 2) return launch<Int8KV<D, false>, kDropLastSplit>"
            in body)
    assert "if (path == 3) return launch<Int8KV<D, true>, kNoFault>" in body
    assert "if (a.block <= 0 || a.block % d ||" in body
    assert (fused_cc.VERIFY_FIRST_DESIGN, fused_cc.VERIFY_SPLIT) == (0, 1)


# ------------------------------------------- a model of the arithmetic

def _bf16_terms(x, n):
    """x (fp32) as n bf16 terms, each the rounding of what is left."""
    terms, rest = [], x
    for _ in range(n):
        t = rest.bfloat16().float()
        terms.append(t)
        rest = rest - t
    return terms


def _merge(parts):
    """Partial softmax states (m, l, acc) merged in index order."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    e = [torch.exp(p[0] - m) for p in parts]
    l_sum = sum(ei * p[1] for ei, p in zip(e, parts))
    acc = sum(ei[..., None] * p[2] for ei, p in zip(e, parts))
    return [m, l_sum, acc]


def _step(st, qr, kc, ksc, vc, vsc, keys, pos, key_end, sm_scale, p_terms):
    """One warp's update over a 16-key step: qr [g, rows, d] bf16 values,
    kc/vc [g, 16, d] codes, ksc/vsc [g, 16] their key rows' scales."""
    s = torch.einsum("grd,gkd->grk", qr, kc) * ksc[:, None, :] * sm_scale
    masked = (keys[None, :] > pos[:, None]) | (keys[None, :] >= key_end)
    mx = s.masked_fill(masked, NEG_INF).amax(-1)
    m_new = torch.maximum(st[0], mx)
    alpha = torch.exp(st[0] - m_new)
    p = torch.exp(s - m_new[..., None]).masked_fill(masked, 0.0)
    pv = 0.0
    for term in reversed(_bf16_terms(p * vsc[:, None, :], p_terms)):
        pv = pv + torch.einsum("grk,gkd->grd", term, vc)  # smallest first
    st[1] = alpha * st[1] + p.sum(-1)
    st[2] = alpha[..., None] * st[2] + pv
    st[0] = m_new


def int8_model(q, kq, ks, vq, vs, starts, sm_scale, splits=None, p_terms=3):
    """The split body's arithmetic: q [w, b, g, rep, d] bf16, kq/vq [T, b,
    nb, B] int8, ks/vs [T, b, nb, 1] fp32, starts [b] ints -> ctx [w, b,
    g, rep, d] fp32. A cell (bi, gi) reads lanes gi * d .. of each row and
    the scale of block gi * d // B."""
    w, b, g, rep, d = q.shape
    T, _, nb, B = kq.shape
    n_rows = w * rep
    tiles, planned = kv.plan(n_rows, b * g, H100_SMS)
    splits = splits or planned
    qf = q.float().permute(1, 2, 0, 3, 4).reshape(b, g, n_rows, d)

    def cells(codes, scales):
        c = codes.reshape(T, b, nb * B)[..., :g * d].reshape(T, b, g, d)
        sc = scales[..., 0][:, :, torch.arange(g) * d // B]  # [T, b, g]
        return c.float().permute(1, 2, 0, 3), sc.permute(1, 2, 0)

    kc, ksc = cells(kq, ks)
    vc, vsc = cells(vq, vs)
    out = torch.zeros(b, g, n_rows, d)
    for bi in range(b):
        start = int(starts[bi])
        for tile in range(tiles):
            row0, row_end = tile * kv.ROWS, min((tile + 1) * kv.ROWS, n_rows)
            r = torch.arange(row0, row_end)
            pos = start + r // rep
            t_lo, t_hi = kv.live_range(start, row0, row_end, rep, None, T)
            parts = []
            for s in range(splits):
                lo, hi = kv.split_keys(t_lo, t_hi, s, splits)
                warps = [[torch.full((g, len(r)), NEG_INF),
                          torch.zeros(g, len(r)), torch.zeros(g, len(r), d)]
                         for _ in range(4)]
                for i, k0 in enumerate(range(lo, hi, kv.STEP)):
                    keys = torch.arange(k0, k0 + kv.STEP)
                    rows_k = keys.clamp(max=T - 1)
                    _step(warps[i % 4], qf[bi, :, r], kc[bi][:, rows_k],
                          ksc[bi][:, rows_k], vc[bi][:, rows_k],
                          vsc[bi][:, rows_k], keys, pos, hi, sm_scale,
                          p_terms)
                parts.append(_merge(warps))
            m, l_sum, acc = _merge(parts)
            out[bi, :, r] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out.reshape(b, g, w, rep, d).permute(2, 0, 1, 3, 4)


def _store(seed, T, b, g, d, block, w):
    """numpy-seeded q [w, b, g, rep 4, d] (bf16 values) and an int8 store
    (codes in [-127, 127], scales 1e-3 to 5e-2) of g * d lanes in blocks
    of ``block``."""
    rs = np.random.RandomState(seed)
    nb = -(-(g * d) // block)
    q = rs.randn(w, b, g, 4, d).astype(np.float32)
    q = torch.from_numpy(q).bfloat16().float().numpy()  # bf16 values
    kq, vq = (rs.randint(-127, 128, (T, b, nb, block)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rs.uniform(1e-3, 5e-2, (T, b, nb, 1)).astype(np.float32)
              for _ in range(2))
    return q, kq, ks, vq, vs


def test_model_matches_jax_interpret_kernel():
    """g 2, rep 4, d 64, T 128, the store's block 128 (g * d lanes), two
    slots at starts 3 and 100: the model against JAX's Pallas verify
    kernel, run once a slot."""
    w, b, g, d, T = 5, 2, 2, 64, 128
    q, kq, ks, vq, vs = _store(1, T, b, g, d, 128, w)
    starts = [3, 100]
    sm = d ** -0.5
    assert fused_cc.verify_plan(2, d, 128, True) == fused_cc.VERIFY_SPLIT
    got = int8_model(torch.from_numpy(q).bfloat16(),
                     *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
                     starts, sm)
    for bi, start in enumerate(starts):
        want = jax_fused_cc.spec_verify_attention(
            jnp.asarray(q[:, bi], jnp.bfloat16),
            *(jnp.asarray(a[:, bi]) for a in (kq, ks, vq, vs)), start, sm)
        np.testing.assert_allclose(got[:, bi].numpy(), np.asarray(want),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("splits", [1, 16])
def test_model_at_forced_splits_matches_the_plain_version(splits):
    """Four slots at their own starts over a 600-row store, blocks of 64
    (B = d: one block a cell), S = 1 and S = 16 (the chip checks' forced
    counts): the model against ``spec_verify_reference`` (dequantize,
    then the window attention's einsum)."""
    w, b, g, d, T = 5, 4, 2, 64, 600
    q, kq, ks, vq, vs = _store(2, T, b, g, d, 64, w)
    starts = torch.tensor([0, 17, 300, T - w], dtype=torch.int32)
    sm = d ** -0.5
    args = [torch.from_numpy(a) for a in (kq, ks, vq, vs)]
    want = fused_cc.spec_verify_reference(torch.from_numpy(q), *args,
                                          starts, sm)
    got = int8_model(torch.from_numpy(q).bfloat16(), *args, starts, sm,
                     splits=splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_p_times_vs_rounded_once_to_bf16_misses_the_limit():
    """Why P.V takes p * vs as three bf16 terms: rounded once, the
    product is off by up to 2^-9 of itself and the output by more than
    ATTN_TOL at the same shapes."""
    w, b, g, d, T = 5, 4, 2, 64, 600
    q, kq, ks, vq, vs = _store(2, T, b, g, d, 64, w)
    starts = torch.tensor([0, 17, 300, T - w], dtype=torch.int32)
    sm = d ** -0.5
    args = [torch.from_numpy(a) for a in (kq, ks, vq, vs)]
    want = fused_cc.spec_verify_reference(torch.from_numpy(q), *args,
                                          starts, sm)
    got = int8_model(torch.from_numpy(q).bfloat16(), *args, starts, sm,
                     p_terms=1)
    assert (got - want).abs().max().item() > ATTN_TOL


def test_model_reads_only_the_cells_block_scale():
    """Blocks of B = d, one a group: raising group 1's key scales moves
    group 1's output and leaves group 0's as it was (the kernel's scale
    index, block gi * d / B, is the model's)."""
    w, b, g, d, T = 5, 1, 2, 64, 64
    q, kq, ks, vq, vs = _store(3, T, b, g, d, d, w)
    tq = torch.from_numpy(q).bfloat16()
    args = [torch.from_numpy(a) for a in (kq, ks, vq, vs)]
    base = int8_model(tq, *args, [40], d ** -0.5)
    ks1 = args[1].clone()
    ks1[:, :, 1] *= 2.0  # group 1's block only
    moved = int8_model(tq, args[0], ks1, args[2], args[3], [40], d ** -0.5)
    assert torch.equal(moved[:, :, 0], base[:, :, 0])
    assert (moved[:, :, 1] - base[:, :, 1]).abs().max() > ATTN_TOL
    assert re.search(r"gi \* D / a\.block",
                     (_CSRC / "kv_attention.cuh").read_text())
