"""The launch plan of the RMSNorm backward-dx kernel #7
(``apex_tpu_torch.kernels.norm.rms_bwd_plan``) and a PyTorch model of its
register path's arithmetic (``csrc/rms_norm.cu`` ``warp_rms_bwd_dx``), on
the CPU.

The plan picks, from shapes and alignment alone, the register path with
16-byte accesses, the register path with one element an access, or one
block a row past RMS_BWD_REG_MAX_H, and how many warps hold a row; the
tests hold that each shape reaches its branch, that every register row up
to the limit is covered, and that the plan's numbers agree with the
kernel's constants.

The model repeats the kernel's fp32 operations in its order: element j =
(it * 32 * warps + lane) * vec + e of a row sits in lane ``lane`` of the
row's 32 * warps lanes; each of the two row sums, taken in one pass (x*x;
w*dy*x), is each lane's partial over its elements in (it, e) order, then
the xor butterfly over each warp's 32 lanes, then the warps' sums added
in order; rstd = rsqrt(sum(x*x) / h + eps) and c = mean(w*dy*xhat) =
(rstd * sum(w*dy*x)) / h, rstd taken out of the sum.
It is held against JAX's Pallas ``_rms_bwd_kernel`` in interpret mode, on
numpy-seeded inputs, within the tolerance of ``tests/test_torch_norm.py``
(fp32 dx 1e-5 relative plus 1e-6 of the largest |dx|; bf16 one ulp), and
against the port's plain version within the card check's NORM_BWD_RTOL.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import norm as jax_norm
from apex_tpu_torch.kernels import norm
from torch_threads import one_torch_thread  # noqa: F401

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_SIZE = {"float32": 4, "bfloat16": 2}
_SOURCE = (Path(norm.__file__).resolve().parent.parent / "csrc"
           / "rms_norm.cu")
V, S, B = norm.LN_BWD_VECTOR, norm.LN_BWD_SCALAR, norm.LN_BWD_BLOCK
LIMIT = norm.RMS_BWD_REG_MAX_H
PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "float32"), ("bfloat16", "bfloat16")]

# ------------------------------------------------------------- the plan

# (h, dy dtype, x dtype, aligned) -> (path, elements an access, chunks a
# lane, warps a row)
PLAN_CASES = [
    # TinyLlama's rows (the path: bf16 dy and x), and their fp32 forms
    ((2048, "bfloat16", "bfloat16", True), (V, 8, 4, 2)),
    ((2048, "float32", "bfloat16", True), (V, 8, 4, 2)),
    ((2048, "float32", "float32", True), (V, 4, 8, 2)),
    ((1024, "bfloat16", "bfloat16", True), (V, 8, 4, 1)),
    ((1000, "float32", "float32", True), (V, 4, 8, 1)),
    ((256, "bfloat16", "bfloat16", True), (V, 8, 1, 1)),
    ((64, "float32", "float32", True), (V, 4, 1, 1)),
    # not a multiple of the vector: one element an access
    ((2047, "bfloat16", "bfloat16", True), (S, 1, 32, 2)),
    ((1001, "bfloat16", "float32", True), (S, 1, 32, 1)),
    ((1, "float32", "float32", True), (S, 1, 1, 1)),
    ((33, "float32", "float32", True), (S, 1, 2, 1)),
    # a pointer off a 16-byte boundary: one element an access
    ((2048, "bfloat16", "bfloat16", False), (S, 1, 32, 2)),
    # past the register limit: one block a row
    ((LIMIT + 8, "bfloat16", "bfloat16", True), (B, 1, 0, 0)),
    ((4096, "float32", "float32", True), (B, 1, 0, 0)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_plan_picks_the_branch(args, want):
    h, tdy, tx, aligned = args
    p = norm.rms_bwd_plan(h, _SIZE[tdy], _SIZE[tx], aligned)
    assert tuple(p) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_takes_alignment_from_the_pointer(dtype):
    """A contiguous view at a 4-byte offset reads one element an access;
    the tensor it is cut from reads 16 bytes."""
    size = _SIZE[dtype]
    flat = torch.zeros(2 * 2048 + 8, dtype=_TORCH[dtype])
    x = flat[4 // size:][:2 * 2048].view(2, 2048)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert norm.rms_bwd_plan(2048, size, size,
                             flat.data_ptr() % 16 == 0).path == V
    assert norm.rms_bwd_plan(2048, size, size,
                             x.data_ptr() % 16 == 0).path == S


@pytest.mark.parametrize("tdy,tx", PAIRS)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_register_row(tdy, tx, aligned):
    """For every h up to the limit (h = 2048, the path's width,
    included): a register path whose 32 * warps lanes of ``iters`` chunks
    of ``vec`` hold the row (the least power of two of chunks that does),
    at most RMS_BWD_LANE_MAX elements of each operand a lane, on the
    fewest warps (a power of two up to RMS_BWD_MAX_WARPS) that allow it,
    16-byte accesses only where h is a multiple of both operands' vectors
    and the pointers are aligned; past the limit, one block a row."""
    dy_size, x_size = _SIZE[tdy], _SIZE[tx]
    wide = 16 // min(dy_size, x_size)
    for h in range(1, LIMIT + 1):
        p = norm.rms_bwd_plan(h, dy_size, x_size, aligned)
        vector = aligned and h % (16 // dy_size) == 0 \
            and h % (16 // x_size) == 0
        assert p.path == (V if vector else S)
        assert p.vec == (wide if vector else 1)
        assert p.iters & (p.iters - 1) == 0  # a power of two
        assert p.warps in (1, 2, 4, 8) and p.warps <= norm.RMS_BWD_MAX_WARPS
        lanes = 32 * p.warps
        assert p.iters * lanes * p.vec >= h
        assert p.iters == 1 or (p.iters // 2) * lanes * p.vec < h
        assert p.iters * p.vec <= norm.RMS_BWD_LANE_MAX
        if p.warps > 1:  # half the warps would hold too much a lane
            chunks = -(-h // p.vec)
            fewer = -(-chunks // (16 * p.warps))
            assert (1 << (fewer - 1).bit_length()) * p.vec \
                > norm.RMS_BWD_LANE_MAX
    for h in (LIMIT + 1, LIMIT + 8, 2 * LIMIT, 8192):
        assert norm.rms_bwd_plan(h, dy_size, x_size, aligned).path == B


def test_plan_constants_match_the_kernel_source():
    """The plan mirrors csrc/rms_norm.cu: the register limit, the
    elements a lane may hold, the warps a row, the path codes and the
    vector width."""
    src = _SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRegMaxH") == LIMIT
    assert const("kLaneMax") == norm.RMS_BWD_LANE_MAX
    assert const("kMaxRowWarps") == norm.RMS_BWD_MAX_WARPS
    assert re.search(r"if \(path == 0\) return launch_bwd<Tdy, Tx>", src)
    assert "if (path == 2)" in src
    assert "16 / static_cast<int>(sizeof(Tdy) < sizeof(Tx)" in src
    assert ("if (row_warps != 1 && row_warps != 2 && row_warps != 4 && "
            "row_warps != 8)") in src
    assert "int x_dtype, int path, int row_warps," in src
    assert (B, S, V) == (0, 1, 2)


# ------------------------------------------- the register path's arithmetic

def _row_sum(v, p):
    """The kernel's sum of each row of v [n, h] (fp32): each lane's
    partial over its chunks' elements in (it, e) order (the slots past h
    hold 0, which the kernel leaves out: adding 0 changes no sum), the
    xor butterfly over each warp's 32 lanes, then the warps' sums added
    in order from 0; [n, 1] (every lane of a warp ends with the same
    bits: checked)."""
    n, h = v.shape
    lanes = 32 * p.warps
    v = torch.nn.functional.pad(v, (0, p.iters * lanes * p.vec - h))
    held = v.reshape(n, p.iters, lanes, p.vec)
    part = torch.zeros(n, lanes)
    for it in range(p.iters):
        for e in range(p.vec):
            part = part + held[:, it, :, e]
    warps = part.reshape(n, p.warps, 32)
    idx = torch.arange(32)
    off = 16
    while off:
        warps = warps + warps[:, :, idx ^ off]
        off //= 2
    assert torch.equal(warps, warps[:, :, :1].expand(n, p.warps, 32))
    if p.warps == 1:
        return warps[:, 0, :1]
    total = torch.zeros(n, 1)
    for k in range(p.warps):
        total = total + warps[:, k, :1]
    return total


def register_rms_bwd_model(dy, x, w, eps):
    """dx of #7's register path on rows x [n, h] with dy [n, h] and the
    fp32 weight [h] (the wrapper passes ones for None), as the kernel
    computes it for rows aligned as a fresh tensor is: fp32 throughout,
    dx in x's dtype."""
    n, h = x.shape
    p = norm.rms_bwd_plan(h, dy.element_size(), x.element_size(), True)
    assert p.path != B
    xf, g = x.float(), dy.float()
    w = torch.ones(h) if w is None else w
    hh = torch.full((n, 1), float(h))  # a tensor: no scalar reciprocal
    wdy = g * w
    ss, t = _row_sum(xf * xf, p), _row_sum(wdy * xf, p)
    rstd = torch.rsqrt(ss / hh + eps)
    c = (t * rstd) / hh
    xhat = xf * rstd
    return ((wdy - xhat * c) * rstd).to(x.dtype)


def _inputs(shape, affine):
    rng = np.random.RandomState(sum(shape) + 3 * affine)
    x = (rng.randn(*shape) * 2.0 - 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(shape[1])).astype(np.float32) if affine \
        else None
    return dy, x, w


# widths on each warps-a-row branch the plan takes: 1 (256, 1000, 1001), 2
# (2048 and 2047, the path's width)
SHAPES = [(6, 256), (5, 1000), (3, 1001), (4, 2048), (3, 2047)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tdy,tx", PAIRS)
@pytest.mark.parametrize("affine", [True, False])
def test_register_model_matches_jax_kernel(shape, tdy, tx, affine):
    dy, x, w = _inputs(shape, affine)
    want = np.asarray(jax_norm.rms_bwd_dx(
        jnp.asarray(dy, _JAX[tdy]), jnp.asarray(x, _JAX[tx]),
        None if w is None else jnp.asarray(w), 1e-5,
        interpret=True).astype(jnp.float32))
    got = register_rms_bwd_model(
        torch.from_numpy(dy).to(_TORCH[tdy]),
        torch.from_numpy(x).to(_TORCH[tx]),
        None if w is None else torch.from_numpy(w), 1e-5)
    assert got.dtype == _TORCH[tx] and got.shape == x.shape
    got = got.float().numpy()
    if tx == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_register_model_matches_the_plain_version(shape):
    """The model and the port's plain version (the card's yardstick) agree
    within the card check's fp32 tolerance (NORM_BWD_RTOL: 1e-5 relative,
    1e-5 of the largest |dx|)."""
    dy, x, w = (torch.from_numpy(a) for a in _inputs(shape, True))
    got = register_rms_bwd_model(dy, x, w, 1e-5)
    want = norm.rms_bwd_dx_plain(dy, x, w, 1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
