"""The launch plan of the scaled, masked and causal softmax forwards
#8/#9/#10 and of the backward #11 (``apex_tpu_torch.kernels.softmax.plan``)
and PyTorch models of the register paths' arithmetic (``csrc/softmax.cu``
``warp_softmax_fwd``, ``warp_causal_fwd``, ``warp_softmax_bwd``), on the
CPU; and the ctypes signatures of the softmax, LayerNorm, optimizer, MLA
decode, int8 block and int8-cache verify wrappers against their C
definitions.

The plan picks, from shapes and alignment alone, the register path with
16-byte accesses, the register path with one key an access, or the block
path past REG_MAX_KEYS; the tests hold that each shape reaches its
branch and that the plan's numbers agree with the kernel's constants.

The model repeats the kernel's fp32 operations in its order: x * scale,
masked keys -10000 in the max and -inf in the exp, padding keys -inf
and out of the max, exp(v - max), each lane's partial sum over its own
keys in the order it holds them, then the xor butterfly over the row's
lanes, then e / sum. It is held against JAX's Pallas ``_masked_fwd_kernel``
and ``_fwd_kernel`` in interpret mode, on numpy-seeded inputs, within
the tolerances of ``tests/test_torch_softmax.py`` (fp32 1e-6 relative:
only the order of the row sum differs; bf16 one ulp). A fully masked row
is NaN (0 / 0) on both sides. The causal model reads only the live keys
(a prefix of each row), starts the max at -10000 when a key is dead and
is held against JAX's ``scaled_upper_triang_masked_softmax`` the same
way, rows with no live key (sq > sk) or with every live score far below
-10000 NaN on both sides. The backward's model sums t = dy * y as each
lane's partial over its own keys in order (padding keys 0), then the
butterfly, and writes (scale * y) * (dy - t); it is held against JAX's
``_bwd_rows`` in interpret mode within ``tests/test_torch_softmax.py``'s
gradient tolerance (fp32 1e-5 relative plus 1e-6; bf16 one ulp).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import softmax as jax_softmax
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu_torch.contrib import mla_decode
from apex_tpu_torch.kernels import (
    _build,
    fused_cc,
    norm,
    optim,
    quant,
    softmax,
)
from torch_threads import one_torch_thread  # noqa: F401

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": dict(rtol=1e-6, atol=1e-7),
        "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
_GRAD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
             "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
_SIZE = {"float32": 4, "bfloat16": 2}
_SOURCE = (Path(softmax.__file__).resolve().parent.parent / "csrc"
           / "softmax.cu")


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["softmax"])
    yield
    reg.force_interpret(False, ["softmax"])


# ------------------------------------------------------------- the plan

V, S, B = softmax.VECTOR, softmax.SCALAR, softmax.BLOCK

# (sk, dtype, aligned) -> (path, keys an access, padded keys, lanes a row,
# rows a block)
PLAN_CASES = [
    # BERT-large's scores: a float4 a lane, a row a warp
    ((128, "float32", True), (V, 4, 128, 32, 4)),
    # the same row in bf16: 16 lanes a row, two rows a warp
    ((128, "bfloat16", True), (V, 8, 128, 16, 8)),
    # short rows share a warp
    ((32, "float32", True), (V, 4, 32, 8, 16)),
    ((32, "bfloat16", True), (V, 8, 32, 4, 32)),
    ((4, "float32", True), (V, 4, 4, 1, 128)),
    # sk a multiple of the vector, padded to a power of two
    ((36, "float32", True), (V, 4, 64, 16, 8)),
    # the register limit
    ((softmax.REG_MAX_KEYS, "float32", True), (V, 4, 1024, 32, 4)),
    ((softmax.REG_MAX_KEYS, "bfloat16", True), (V, 8, 1024, 32, 4)),
    # sk not a multiple of the vector: one key an access
    ((357, "float32", True), (S, 1, 512, 32, 4)),
    ((357, "bfloat16", True), (S, 1, 512, 32, 4)),
    ((36, "bfloat16", True), (S, 1, 64, 32, 4)),
    ((1, "float32", True), (S, 1, 1, 1, 128)),
    ((5, "bfloat16", True), (S, 1, 8, 8, 16)),
    # a pointer off a 16-byte boundary: one key an access
    ((128, "float32", False), (S, 1, 128, 32, 4)),
    ((128, "bfloat16", False), (S, 1, 128, 32, 4)),
    ((softmax.REG_MAX_KEYS, "float32", False), (S, 1, 1024, 32, 4)),
    # past the register limit: one block a row
    ((softmax.REG_MAX_KEYS + 1, "float32", True), (B, 1, 1025, 256, 1)),
    ((softmax.REG_MAX_KEYS + 1, "bfloat16", False), (B, 1, 1025, 256, 1)),
    ((softmax.MAX_KEYS, "float32", True), (B, 1, 16384, 256, 1)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_plan_picks_the_branch(args, want):
    sk, dtype, aligned = args
    p = softmax.plan(sk, _SIZE[dtype], aligned)
    assert (p.path, p.vec, p.keys, p.lanes, p.rows_per_block) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_takes_alignment_from_the_pointer(dtype):
    """A contiguous view at a 4-byte offset reads one key an access; the
    tensor it is cut from reads 16 bytes."""
    flat = torch.zeros(2 * 128 + 8, dtype=_TORCH[dtype])
    x = flat[4 // _SIZE[dtype]:][:2 * 128].view(2, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert softmax.plan(128, _SIZE[dtype],
                        flat.data_ptr() % 16 == 0).path == softmax.VECTOR
    assert softmax.plan(128, _SIZE[dtype],
                        x.data_ptr() % 16 == 0).path == softmax.SCALAR


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_register_row(itemsize, aligned):
    """For every sk up to REG_MAX_KEYS: the padded row is the least power
    of two >= sk, lanes x vectors x keys a vector tile it exactly, a row's
    lanes are a power of two dividing 32 (so the butterfly stays inside
    the row's group), a block is WARPS warps, and 16-byte accesses only
    where sk is a multiple of the vector and the pointers are aligned."""
    for sk in range(1, softmax.REG_MAX_KEYS + 1):
        p = softmax.plan(sk, itemsize, aligned)
        assert p.path in (softmax.VECTOR, softmax.SCALAR)
        assert p.keys >= sk > p.keys // 2
        assert p.lanes * p.iters * p.vec == p.keys
        assert 32 % p.lanes == 0
        assert p.lanes == 32 or p.iters == 1  # a short row: one vector a lane
        assert p.rows_per_block * p.lanes == softmax.WARPS * 32
        vector = aligned and sk % (16 // itemsize) == 0
        assert (p.path == softmax.VECTOR) == vector
        assert p.vec == (16 // itemsize if vector else 1)
        assert p.iters * p.vec <= 32  # at most 32 keys in a lane's registers


def test_plan_constants_match_the_kernel_source():
    """The plan mirrors csrc/softmax.cu: the register limit, the warps of
    a register block, the block path's threads and the path codes."""
    src = _SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert 1 << const("kRegMaxLog2") == softmax.REG_MAX_KEYS
    assert const("kWarps") == softmax.WARPS
    assert const("kThreads") == softmax.BLOCK_THREADS
    assert re.search(r"if \(path == 0\)\s+return launch_masked<T>", src)
    assert "if (path == 2) {" in src
    assert (softmax.BLOCK, softmax.SCALAR, softmax.VECTOR) == (0, 1, 2)


# ------------------------------------------- the register path's arithmetic

def register_softmax_model(x, mask, scale):
    """The register path of #8 (``mask`` None) / #9 on x [..., sk], as the
    kernel computes it, for rows aligned as a fresh tensor is (the plan
    with ``aligned`` True): fp32 throughout, the row sum as lane partials
    in the order each lane holds its keys, then the xor butterfly.
    Returns (y in x's dtype, the butterfly's sums [rows, lanes])."""
    sk = x.shape[-1]
    p = softmax.plan(sk, x.element_size(), True)
    assert p.path != softmax.BLOCK
    rows = x.numel() // sk
    s = x.float().reshape(rows, sk) * scale
    if mask is None:
        m = torch.zeros(rows, sk, dtype=torch.bool)
    else:
        m = (mask != 0).expand(x.shape).reshape(rows, sk)
    neg_inf = torch.tensor(float("-inf"))
    pad = p.keys - sk
    v = torch.nn.functional.pad(torch.where(m, neg_inf, s), (0, pad),
                                value=float("-inf"))
    mx = torch.nn.functional.pad(torch.where(m, softmax.MASK_VALUE, s),
                                 (0, pad), value=float("-inf"))
    mx = mx.amax(-1, keepdim=True)
    e = torch.exp(v - mx)
    part = _lane_sums(e, p)
    y = e / part[:, :1]
    return y[:, :sk].reshape(x.shape).to(x.dtype), part


def _lane_sums(e, p):
    """The register path's row sums of e [rows, p.keys] (fp32): each
    lane's partial over its own keys in the order it holds them (key k =
    (it * lanes + lane) * vec + j: lane `lane` holds [it, j]), then the
    xor butterfly over the row's lanes. Returns [rows, lanes]."""
    lanes = e.reshape(e.shape[0], p.iters, p.lanes, p.vec)
    part = torch.zeros(e.shape[0], p.lanes)
    for it in range(p.iters):
        for j in range(p.vec):
            part = part + lanes[:, it, :, j]
    idx = torch.arange(p.lanes)
    off = p.lanes // 2
    while off:
        part = part + part[:, idx ^ off]
        off //= 2
    return part


def _mask(seed, shape):
    """About a third of the keys masked, key 0 of every row live, row 1
    of the first (b, n) fully masked."""
    m = np.random.RandomState(seed).rand(*shape) < 0.35
    m[..., 0] = False
    m[(0,) * (m.ndim - 2) + (1,)] = True
    return m


# (x shape, mask shape): the mask broadcast over heads, as BERT's
MODEL_CASES = [((2, 3, 16, 128), (2, 1, 16, 128)),
               ((2, 3, 5, 357), (2, 1, 5, 357)),
               ((2, 3, 4, 36), (2, 1, 4, 36)),
               ((1, 2, 3, 1024), (1, 1, 3, 1024))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xshape,mshape", MODEL_CASES)
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_register_model_matches_jax_masked_kernel(dtype, xshape, mshape,
                                                  scale):
    x = (np.random.RandomState(sum(xshape)).randn(*xshape)
         .astype(np.float32) * 4)
    m = _mask(sum(mshape), mshape)
    maskf = jnp.asarray(np.broadcast_to(m, xshape).astype(np.float32))
    want = np.asarray(jax_softmax.scaled_masked_softmax(
        jnp.asarray(x, _JAX[dtype]), maskf, scale).astype(jnp.float32))
    got, part = register_softmax_model(torch.from_numpy(x).to(_TORCH[dtype]),
                                       torch.from_numpy(m), scale)
    assert got.dtype == _TORCH[dtype] and got.shape == x.shape
    # every lane of a row ends the butterfly with the same sum, bit for bit
    sums = part.numpy()
    assert np.array_equal(np.isnan(sums), np.isnan(sums[:, :1]).repeat(
        sums.shape[1], 1))
    assert np.array_equal(sums[~np.isnan(sums)],
                          sums[:, :1].repeat(sums.shape[1], 1)[
                              ~np.isnan(sums)])
    full = np.broadcast_to(m, xshape)
    dead = full.all(-1)
    assert dead.any()
    got = got.float().numpy()
    assert np.isnan(want[dead]).all() and np.isnan(got[dead]).all()
    assert not np.isnan(got[~dead]).any()
    np.testing.assert_allclose(got[~dead], want[~dead], **_TOL[dtype])
    assert (got[full & ~dead[..., None]] == 0).all()  # masked keys exactly 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 16, 128), (2, 3, 5, 357),
                                   (6, 32)])
def test_register_model_matches_jax_scaled_kernel(dtype, shape):
    x = np.random.RandomState(len(shape) + shape[-1]).randn(*shape).astype(
        np.float32) * 4
    want = np.asarray(jax_softmax.scaled_softmax(
        jnp.asarray(x, _JAX[dtype]), 0.5).astype(jnp.float32))
    got, _ = register_softmax_model(torch.from_numpy(x).to(_TORCH[dtype]),
                                    None, 0.5)
    np.testing.assert_allclose(got.float().numpy(), want, **_TOL[dtype])


@pytest.mark.parametrize("xshape,mshape", MODEL_CASES[:2])
def test_register_model_matches_the_plain_version(xshape, mshape):
    """The model and the port's plain version (the card's yardstick) agree
    within the card check's fp32 tolerance, NaN for NaN."""
    x = torch.from_numpy(np.random.RandomState(3).randn(*xshape).astype(
        np.float32) * 4)
    m = torch.from_numpy(_mask(4, mshape))
    got, _ = register_softmax_model(x, m, 1.0)
    want = softmax.scaled_masked_softmax_fwd_plain(x, m, 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


# ------------------------------------- the causal forward #10 (same plan)

def causal_register_model(x, scale):
    """The causal register path of #10 (``warp_causal_fwd``) on x [B, sq,
    sk], as the kernel computes it for rows aligned as a fresh tensor is:
    key j of row r live when j < live = clamp(r % sq + sk - sq + 1, 0,
    sk); x * scale on the live keys, -inf on the dead ones (never read);
    the max starts at -10000 when the row has a dead key; exp(v - max);
    the row sum as :func:`_lane_sums` (a lane skips its dead vectors,
    whose exp is exactly 0); e / sum, so a dead key is 0 / sum. Returns
    (y in x's dtype, the butterfly's sums [rows, lanes])."""
    _, sq, sk = x.shape
    p = softmax.plan(sk, x.element_size(), True)
    assert p.path != softmax.BLOCK
    rows = x.numel() // sk
    live = (torch.arange(rows) % sq + (sk - sq) + 1).clamp(0, sk)[:, None]
    alive = torch.arange(p.keys)[None, :] < live
    s = torch.nn.functional.pad(x.float().reshape(rows, sk) * scale,
                                (0, p.keys - sk))
    v = torch.where(alive, s, float("-inf"))
    mx = v.amax(-1, keepdim=True)
    mx = torch.where(live < sk, mx.clamp_min(softmax.MASK_VALUE), mx)
    e = torch.exp(v - mx)
    part = _lane_sums(e, p)
    y = e / part[:, :1]
    return y[:, :sk].reshape(x.shape).to(x.dtype), part


def _causal_input(shape, low_row):
    """Scores x 4 from a numpy seed; with ``low_row`` row 1 of batch 0
    lies far below -10000 (its max is -10000, every exp 0: NaN) and row 2
    just below (a sum of tiny exps)."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    x *= 4
    if low_row:
        x[0, 1] = -20000.0
        x[0, 2] = -10048.0  # exact in bf16
    return x


# (x shape, a row below -10000): sq = sk, the path's row length, sq < sk,
# sk odd (one key an access), sq > sk (rows with no live key: NaN)
CAUSAL_CASES = [((2, 128, 128), True), ((1, 48, 1024), True),
                ((2, 40, 100), False), ((2, 30, 357), True),
                ((2, 40, 32), False), ((3, 9, 8), True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,low_row", CAUSAL_CASES)
def test_causal_model_matches_jax_kernel(dtype, shape, low_row):
    x = _causal_input(shape, low_row)
    want = np.asarray(jax_softmax.scaled_upper_triang_masked_softmax(
        jnp.asarray(x, _JAX[dtype]), 1.0).astype(jnp.float32))
    got, part = causal_register_model(torch.from_numpy(x).to(_TORCH[dtype]),
                                      1.0)
    assert got.dtype == _TORCH[dtype] and got.shape == x.shape
    sums = part.numpy()  # every lane ends with the row's sum, bit for bit
    assert np.array_equal(sums, sums[:, :1].repeat(sums.shape[1], 1),
                          equal_nan=True)
    got = got.float().numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    _, sq, sk = shape
    live = np.tril(np.ones((sq, sk), dtype=bool), sk - sq)
    if sq > sk or low_row:
        assert nan.all(-1).any()  # the case has its NaN rows
    assert (got[np.broadcast_to(~live, x.shape) & ~nan] == 0).all()
    np.testing.assert_allclose(got[~nan], want[~nan], **_TOL[dtype])


@pytest.mark.parametrize("shape,low_row", CAUSAL_CASES[:2])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_causal_model_matches_the_plain_version(shape, low_row, scale):
    """The model and the port's plain version (the card's yardstick) agree
    within the card check's fp32 tolerance, NaN for NaN."""
    x = torch.from_numpy(_causal_input(shape, low_row))
    got, _ = causal_register_model(x, scale)
    want = softmax.causal_softmax_fwd_plain(x, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


def test_causal_path_codes_match_the_kernel_source():
    """apex_causal_softmax_fwd's path: the plan's codes (0 the first
    design's block a row, 1 and 2 the register path with one key or 16
    bytes an access), 3 and 4 planted faults on 1024-key rows."""
    src = _SOURCE.read_text()
    assert re.search(r"if \(path == 0\) return launch_fwd<T>", src)
    assert re.search(r"if \(path == 1\)\s+return dispatch_causal_rows<T, "
                     r"false>", src)
    assert re.search(r"if \(path == 2\)\s+return dispatch_causal_rows<T, "
                     r"true>", src)
    assert re.search(r"if \(path == 3\)\s+return launch_causal_rows<T, "
                     r"kRegMaxLog2, true, kDropDiagonal>", src)
    assert re.search(r"return launch_causal_rows<T, kRegMaxLog2, true, "
                     r"kShortSum>", src)
    assert "if (path < 1 || path > 4) return -1;" in src


# ------------------------------------------ the backward #11 (same plan)

def register_softmax_bwd_model(y, dy, scale):
    """dx of #11's register path (``warp_softmax_bwd``) on y, dy [...,
    sk], as the kernel computes it for rows aligned as a fresh tensor is:
    padding keys past sk hold 0 in y and dy; t = sum(dy * y) as
    :func:`_lane_sums` (each product rounded, then each lane's partial in
    order, then the butterfly); dx = (scale * y) * (dy - t) in fp32,
    returned in y's dtype. Returns (dx, the butterfly's sums [rows,
    lanes])."""
    sk = y.shape[-1]
    p = softmax.plan(sk, y.element_size(), True, softmax.BWD_REG_MAX_KEYS)
    assert p.path != softmax.BLOCK
    rows = y.numel() // sk
    pad = (0, p.keys - sk)
    yf = torch.nn.functional.pad(y.float().reshape(rows, sk), pad)
    gf = torch.nn.functional.pad(dy.float().reshape(rows, sk), pad)
    part = _lane_sums(gf * yf, p)
    dx = (scale * yf) * (gf - part[:, :1])
    return dx[:, :sk].reshape(y.shape).to(y.dtype), part


def _bwd_input(shape, causal):
    """y a softmax over each row (with ``causal``, keys past the
    diagonal 0, as #10 writes them) and dy from a numpy seed."""
    rng = np.random.RandomState(sum(shape) + causal)
    s = rng.randn(*shape).astype(np.float32) * 4
    if causal:
        sq, sk = shape[-2:]
        s = np.where(np.tril(np.ones((sq, sk), bool), sk - sq), s, -np.inf)
    y = np.exp(s - s.max(-1, keepdims=True))
    y = (y / y.sum(-1, keepdims=True)).astype(np.float32)
    return y, rng.randn(*shape).astype(np.float32)


# (shape, causal): BERT's 128 keys (a float4 a lane), a ragged row padded
# to a power of two (one key an access at 357; 16-byte vectors at 100 fp32
# keys), and causal rows with y 0 past the diagonal
BWD_CASES = [((2, 3, 8, 128), False), ((2, 6, 357), False),
             ((3, 5, 100), False), ((2, 48, 128), True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", BWD_CASES)
def test_bwd_model_matches_jax_kernel(dtype, shape, causal):
    y, dy = _bwd_input(shape, causal)
    want = np.asarray(jax_softmax._bwd_rows(
        jnp.asarray(y.reshape(-1, shape[-1]), _JAX[dtype]),
        jnp.asarray(dy.reshape(-1, shape[-1]), _JAX[dtype]), 0.3,
        _JAX[dtype]).astype(jnp.float32)).reshape(shape)
    got, part = register_softmax_bwd_model(
        torch.from_numpy(y).to(_TORCH[dtype]),
        torch.from_numpy(dy).to(_TORCH[dtype]), 0.3)
    assert got.dtype == _TORCH[dtype] and got.shape == y.shape
    sums = part.numpy()  # every lane ends with the row's sum, bit for bit
    assert np.array_equal(sums, sums[:, :1].repeat(sums.shape[1], 1))
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_GRAD_TOL[dtype])


def test_bwd_model_keeps_jax_nan_for_inf_on_a_zero_probability():
    """Every key is read, dead ones too: dy = inf where y = 0 makes t, and
    so the whole row, NaN, as JAX's kernel gives it; the other rows stay
    finite."""
    y, dy = _bwd_input((1, 16, 128), True)
    dy[0, 3, 120] = np.inf  # y is 0 there: past row 3's diagonal (115)
    assert y[0, 3, 120] == 0
    want = np.asarray(jax_softmax._bwd_rows(
        jnp.asarray(y[0]), jnp.asarray(dy[0]), 1.0, jnp.float32))
    got, _ = register_softmax_bwd_model(torch.from_numpy(y),
                                        torch.from_numpy(dy), 1.0)
    got = got[0].numpy()
    assert np.isnan(want[3]).all() and np.isnan(got[3]).all()
    rest = np.arange(16) != 3
    assert np.isfinite(got[rest]).all()
    np.testing.assert_allclose(got[rest], want[rest], **_GRAD_TOL["float32"])


@pytest.mark.parametrize("shape,causal", BWD_CASES[:2])
def test_bwd_model_matches_the_plain_version(shape, causal):
    """The model and the port's plain version (the card's yardstick) agree
    within the card check's fp32 tolerance (SOFTMAX_BWD_RTOL: 1e-5
    relative, 1e-5 of the largest |dx|)."""
    y, dy = (torch.from_numpy(a) for a in _bwd_input(shape, causal))
    got, _ = register_softmax_bwd_model(y, dy, 0.3)
    want = softmax.softmax_bwd_plain(y, dy, 0.3)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


# (sk, dtype, aligned) -> (path, keys an access, padded keys, lanes a row,
# rows a block) of the backward's plan: the forwards' up to
# BWD_REG_MAX_KEYS keys, one block a row past it
BWD_PLAN_CASES = [
    ((128, "float32", True), (V, 4, 128, 32, 4)),
    ((128, "bfloat16", True), (V, 8, 128, 16, 8)),
    ((357, "float32", True), (S, 1, 512, 32, 4)),
    ((128, "float32", False), (S, 1, 128, 32, 4)),
    ((512, "float32", True), (V, 4, 512, 32, 4)),
    ((softmax.BWD_REG_MAX_KEYS, "float32", True), (V, 4, 1024, 32, 4)),
    ((softmax.BWD_REG_MAX_KEYS, "bfloat16", False), (S, 1, 1024, 32, 4)),
    ((softmax.BWD_REG_MAX_KEYS + 4, "float32", True), (B, 1, 772, 256, 1)),
    ((softmax.REG_MAX_KEYS, "float32", True), (B, 1, 1024, 256, 1)),
    ((softmax.REG_MAX_KEYS, "bfloat16", True), (B, 1, 1024, 256, 1)),
]


@pytest.mark.parametrize("args,want", BWD_PLAN_CASES)
def test_bwd_plan_picks_the_branch(args, want):
    sk, dtype, aligned = args
    p = softmax.plan(sk, _SIZE[dtype], aligned, softmax.BWD_REG_MAX_KEYS)
    assert (p.path, p.vec, p.keys, p.lanes, p.rows_per_block) == want


def test_bwd_plan_agrees_with_the_forwards_up_to_its_limit():
    """The backward's register rows are the forwards', key for key, up to
    BWD_REG_MAX_KEYS, and the block path past it."""
    lim = softmax.BWD_REG_MAX_KEYS
    assert lim <= softmax.REG_MAX_KEYS
    for itemsize in (4, 2):
        for aligned in (True, False):
            for sk in range(1, softmax.REG_MAX_KEYS + 2):
                got = softmax.plan(sk, itemsize, aligned, lim)
                if sk <= lim:
                    assert got == softmax.plan(sk, itemsize, aligned)
                else:
                    assert got.path == softmax.BLOCK


def test_bwd_path_codes_match_the_kernel_source():
    """apex_softmax_bwd's path: the plan's codes (0 the first design's
    block a row, 1 and 2 the register path with one key or 16 bytes an
    access), 3 and 4 planted faults on 128-key rows."""
    src = _SOURCE.read_text()
    assert re.search(r"if \(path == 0\) return launch_bwd<T>", src)
    assert re.search(r"if \(path == 1\)\s+return dispatch_bwd_rows<T, "
                     r"false>", src)
    assert re.search(r"if \(path == 2\)\s+return dispatch_bwd_rows<T, "
                     r"true>", src)
    assert "constexpr int kBwdFaultLog2 = 7;" in src
    assert re.search(r"if \(path == 3\)\s+return launch_bwd_rows<T, "
                     r"kBwdFaultLog2, true, kBwdShortSum>", src)
    assert re.search(r"return launch_bwd_rows<T, kBwdFaultLog2, true, "
                     r"kBwdDyAhead>", src)
    assert "if (path < 1 || path > 4) return -1;" in src


def _c_argtypes(source, symbol):
    """The ctypes types of the C function ``symbol``'s parameters, read
    from its definition in ``source``: a pointer c_void_p, else by type."""
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)',
                       source.read_text()).group(1)
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        else:
            kinds.append({"long long": ctypes.c_longlong,
                          "float": ctypes.c_float, "int": ctypes.c_int}[
                param.rsplit(" ", 1)[0].removeprefix("const ")])
    return kinds


@pytest.mark.parametrize("module,loader", [
    (softmax, "_fwd_kernel"), (softmax, "_masked_kernel"),
    (softmax, "_bwd_kernel"), (optim, "_kernel"), (optim, "_lamb_kernel"),
    (norm, "_ln_kernel"), (norm, "_ln_bwd_kernel"), (mla_decode, "_kernel"),
    (quant, "_quant_kernel"), (quant, "_dequant_kernel"),
    (fused_cc, "_verify_kernel")])
def test_ctypes_signatures_match_the_c_functions(monkeypatch, module,
                                                 loader):
    """The argument types each wrapper's loader hands ``_build.function``
    (nothing is built) against the C definition in csrc/<library>.cu:
    the softmax entries (#10 and #11 with their paths), Adam's (with its
    heads and path), LAMB's, LayerNorm's (#4 and #5 with their paths),
    the MLA decode's (#26 with its counters, split sizes and path), the
    int8 block kernels' (#14 and #15 with their paths) and the int8-cache
    verify's (#22 with its splits, scratch, counters and path)."""
    monkeypatch.setattr(_build, "function", lambda lib, symbol, types: (
        lib, symbol, list(types)))
    lib, symbol, types = getattr(module, loader).__wrapped__()
    assert types == _c_argtypes(_SOURCE.with_name(f"{lib}.cu"), symbol)
