"""The launch plan of the scaled and masked softmax forwards #8/#9
(``apex_tpu_torch.kernels.softmax.plan``) and a PyTorch model of the
register path's arithmetic (``csrc/softmax.cu`` ``warp_softmax_fwd``),
on the CPU.

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
is NaN (0 / 0) on both sides.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import softmax as jax_softmax
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu_torch.kernels import softmax

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": dict(rtol=1e-6, atol=1e-7),
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
    # key k = (it * lanes + lane) * vec + j: lane `lane` holds [it, j]
    lanes = e.reshape(rows, p.iters, p.lanes, p.vec)
    part = torch.zeros(rows, p.lanes)
    for it in range(p.iters):
        for j in range(p.vec):
            part = part + lanes[:, it, :, j]
    idx = torch.arange(p.lanes)
    off = p.lanes // 2
    while off:
        part = part + part[:, idx ^ off]
        off //= 2
    y = e / part[:, :1]
    return y[:, :sk].reshape(x.shape).to(x.dtype), part


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
