"""The launch plan of the LayerNorm forward #4 and backward-dx #5
(``apex_tpu_torch.kernels.norm.ln_plan``, one rule on the two row
operands' itemsizes: x and y, or dy and x) and PyTorch models of their
register paths' arithmetic (``csrc/layer_norm.cu`` ``warp_ln_fwd``,
``warp_ln_bwd_dx``), on the CPU.

The plan picks, from shapes and alignment alone, the register path with
16-byte accesses, the register path with one element an access, or one
block a row past LN_BWD_REG_MAX_H; the tests hold that each shape reaches
its branch and that the plan's numbers agree with the kernel's constants.

The model repeats the kernel's fp32 operations in its order: element j =
(it * 32 + lane) * vec + e of a row sits in lane ``lane``; each of the
four row sums (x; the centred squares; w*dy; w*dy*xhat) is each lane's
partial over its elements in (it, e) order, then the xor butterfly over
the 32 lanes, then / h. It is held against JAX's Pallas ``_ln_bwd_kernel``
in interpret mode, on numpy-seeded inputs, within the tolerance of
``tests/test_torch_norm.py``'s ``test_ln_bwd_dx_plain_matches_jax_kernel``
(fp32 dx 1e-5 relative plus 1e-6 of the largest |dx|; bf16 one ulp).
The forward's model sums the mean and the centred squares the same way,
then y = (x - mean) * rstd * w + b rounded to x's dtype and then to y's;
it is held against JAX's Pallas ``_ln_fwd_kernel`` in interpret mode
within ``test_ln_fwd_plain_matches_jax_kernel``'s tolerance (fp32 2e-6
relative plus 1e-6; bf16 one ulp).
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
           / "layer_norm.cu")
V, S, B = norm.LN_BWD_VECTOR, norm.LN_BWD_SCALAR, norm.LN_BWD_BLOCK
LIMIT = norm.LN_BWD_REG_MAX_H

# ------------------------------------------------------------- the plan

# (h, the two row operands' dtypes: dy and x for #5, x and y for #4,
# aligned) -> (path, elements an access, chunks a lane)
PLAN_CASES = [
    # GPT-2's and BERT's rows: bf16/bf16 and the fp32 dy of a bf16 layer
    ((1024, "bfloat16", "bfloat16", True), (V, 8, 4)),
    ((1024, "float32", "bfloat16", True), (V, 8, 4)),
    ((1024, "bfloat16", "float32", True), (V, 8, 4)),
    ((1024, "float32", "float32", True), (V, 4, 8)),
    # a multiple of the vector that leaves the last chunks partly idle
    ((1000, "bfloat16", "bfloat16", True), (V, 8, 4)),
    ((1000, "float32", "float32", True), (V, 4, 8)),
    ((64, "bfloat16", "bfloat16", True), (V, 8, 1)),
    # not a multiple of the vector: one element an access
    ((1001, "bfloat16", "bfloat16", True), (S, 1, 32)),
    ((1020, "bfloat16", "float32", True), (S, 1, 32)),
    ((1, "float32", "float32", True), (S, 1, 1)),
    ((33, "float32", "float32", True), (S, 1, 2)),
    # a pointer off a 16-byte boundary: one element an access
    ((1024, "bfloat16", "bfloat16", False), (S, 1, 32)),
    ((1024, "float32", "float32", False), (S, 1, 32)),
    # past the register limit: one block a row
    ((LIMIT + 8, "bfloat16", "bfloat16", True), (B, 1, 0)),
    ((4096, "float32", "bfloat16", True), (B, 1, 0)),
    ((4096, "float32", "float32", False), (B, 1, 0)),
    # #4's other callers and pairs: BERT's heads and the MHA norm-add
    # (fp32 rows, 8 float4 a lane), fp32 x into bf16 y
    ((256, "float32", "float32", True), (V, 4, 2)),
    ((1001, "float32", "float32", True), (S, 1, 32)),
    ((1020, "float32", "bfloat16", True), (S, 1, 32)),
    ((1024, "bfloat16", "float32", False), (S, 1, 32)),
    ((LIMIT + 8, "float32", "bfloat16", True), (B, 1, 0)),
    ((4096, "bfloat16", "float32", True), (B, 1, 0)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_plan_picks_the_branch(args, want):
    h, tdy, tx, aligned = args
    p = norm.ln_plan(h, _SIZE[tdy], _SIZE[tx], aligned)
    assert (p.path, p.vec, p.iters) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_takes_alignment_from_the_pointer(dtype):
    """A contiguous view at a 4-byte offset reads one element an access;
    the tensor it is cut from reads 16 bytes."""
    size = _SIZE[dtype]
    flat = torch.zeros(2 * 1024 + 8, dtype=_TORCH[dtype])
    x = flat[4 // size:][:2 * 1024].view(2, 1024)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert norm.ln_plan(1024, size, size,
                        flat.data_ptr() % 16 == 0).path == V
    assert norm.ln_plan(1024, size, size,
                        x.data_ptr() % 16 == 0).path == S


@pytest.mark.parametrize("tdy,tx", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_register_row(tdy, tx, aligned):
    """For every h up to the limit: a register path whose 32 lanes of
    ``iters`` chunks of ``vec`` hold the row (the least power of two of
    chunks that does), at most 32 elements of each operand a lane, 16-byte
    accesses only where h is a multiple of both operands' vectors and the
    pointers are aligned; past the limit, one block a row."""
    dy_size, x_size = _SIZE[tdy], _SIZE[tx]
    wide = 16 // min(dy_size, x_size)
    for h in range(1, LIMIT + 1):
        p = norm.ln_plan(h, dy_size, x_size, aligned)
        vector = aligned and h % (16 // dy_size) == 0 \
            and h % (16 // x_size) == 0
        assert p.path == (V if vector else S)
        assert p.vec == (wide if vector else 1)
        assert p.iters & (p.iters - 1) == 0  # a power of two
        assert p.iters * 32 * p.vec >= h > p.iters * 16 * p.vec \
            or p.iters == 1
        assert p.iters * p.vec <= 32
    for h in (LIMIT + 1, LIMIT + 8, 2 * LIMIT, 4096):
        assert norm.ln_plan(h, dy_size, x_size, aligned).path == B


def test_fwd_plan_constants_match_the_kernel_source():
    """#4's launch mirrors #5's in csrc/layer_norm.cu: the first design as
    path 0, the 16-byte vector of the narrower of x and y, the register
    path's limit, the alignment of x and y checked, and the C function's
    path argument."""
    src = _SOURCE.read_text()
    assert re.search(r"if \(path == 0\) return launch_fwd<Tin, Tout>", src)
    assert "sizeof(Tin) < sizeof(Tout) ? sizeof(Tin) : sizeof(Tout)" in src
    assert re.search(r"if \(path == 2 && \(h % kVec != 0 \|\| !aligned16\(x\) "
                     r"\|\| !aligned16\(y\)\)\)", src)
    assert "__launch_bounds__(kRowWarps * 32)\nwarp_ln_fwd(" in src
    assert re.search(r"return launch_fwd_path<\w+, \w+>\(path, ", src)


def test_plan_constants_match_the_kernel_source():
    """The plan mirrors csrc/layer_norm.cu: the register limit, the rows
    of a register block, the path codes and the vector width."""
    src = _SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRegMaxH") == LIMIT
    assert const("kRowWarps") == norm.LN_BWD_ROW_WARPS
    assert re.search(r"if \(path == 0\) return launch_bwd<Tdy, Tx>", src)
    assert "if (path == 2)" in src
    assert "16 / static_cast<int>(sizeof(Tdy) < sizeof(Tx)" in src
    assert (B, S, V) == (0, 1, 2)


# ------------------------------------------- the register path's arithmetic

def _row_sum(v, p):
    """The kernel's sum of each row of v [n, h] (fp32): each lane's
    partial over its chunks' elements in (it, e) order (the slots past h
    hold 0, which the kernel leaves out: adding 0 changes no sum), then
    the xor butterfly over 32 lanes; [n, 1] (every lane ends with the
    same bits: checked)."""
    n, h = v.shape
    v = torch.nn.functional.pad(v, (0, p.iters * 32 * p.vec - h))
    lanes = v.reshape(n, p.iters, 32, p.vec)
    part = torch.zeros(n, 32)
    for it in range(p.iters):
        for e in range(p.vec):
            part = part + lanes[:, it, :, e]
    idx = torch.arange(32)
    off = 16
    while off:
        part = part + part[:, idx ^ off]
        off //= 2
    assert torch.equal(part, part[:, :1].expand(n, 32))
    return part[:, :1]


def register_ln_bwd_model(dy, x, w, eps):
    """dx of #5's register path on rows x [n, h] with dy [n, h] and the
    fp32 weight [h] (or None), as the kernel computes it for rows aligned
    as a fresh tensor is (the plan with ``aligned`` True): fp32
    throughout, the two-pass statistics, dx in x's dtype."""
    n, h = x.shape
    p = norm.ln_plan(h, dy.element_size(), x.element_size(), True)
    assert p.path != B
    xf, g = x.float(), dy.float()
    hh = torch.full((n, 1), float(h))  # a tensor: no scalar reciprocal
    mean = _row_sum(xf, p) / hh
    c = xf - mean
    var = _row_sum(c * c, p) / hh
    rstd = torch.rsqrt(var + eps)
    xhat = c * rstd
    wdy = g * w if w is not None else g
    c1 = _row_sum(wdy, p) / hh
    c2 = _row_sum(wdy * xhat, p) / hh
    return ((wdy - c1 - xhat * c2) * rstd).to(x.dtype)


def _inputs(shape, affine):
    rng = np.random.RandomState(sum(shape) + affine)
    x = (rng.randn(*shape) * 2.0 - 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(shape[1])).astype(np.float32) if affine \
        else None
    return dy, x, w


@pytest.mark.parametrize("shape", [(6, 256), (5, 1000), (5, 1001)])
@pytest.mark.parametrize("tdy,tx", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("affine", [True, False])
def test_register_model_matches_jax_kernel(shape, tdy, tx, affine):
    dy, x, w = _inputs(shape, affine)
    want = np.asarray(jax_norm.ln_bwd_dx(
        jnp.asarray(dy, _JAX[tdy]), jnp.asarray(x, _JAX[tx]),
        None if w is None else jnp.asarray(w), 1e-5,
        interpret=True).astype(jnp.float32))
    got = register_ln_bwd_model(
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


@pytest.mark.parametrize("shape", [(6, 256), (5, 1001)])
def test_register_model_matches_the_plain_version(shape):
    """The model and the port's plain version (the card's yardstick) agree
    within the card check's fp32 tolerance (LN_RTOL: 1e-5 relative, 1e-5
    of the largest |dx|)."""
    dy, x, w = (torch.from_numpy(a) for a in _inputs(shape, True))
    got = register_ln_bwd_model(dy, x, w, 1e-5)
    want = norm.ln_bwd_dx_plain(dy, x, w, 1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


# ------------------------------------------------ the forward's arithmetic

def register_ln_fwd_model(x, w, b, eps, out_dtype):
    """y of #4's register path (``warp_ln_fwd``) on rows x [n, h] with
    the fp32 weight and bias [h] (either may be None), as the kernel
    computes it for rows aligned as a fresh tensor is: the mean and the
    centred sum of squares as :func:`_row_sum` (lane partials, then the
    butterfly), rstd = rsqrt(var + eps), ((x - mean) * rstd) * w + b in
    fp32, rounded to x's dtype and then to ``out_dtype``."""
    n, h = x.shape
    out_size = torch.tensor([], dtype=out_dtype).element_size()
    p = norm.ln_plan(h, x.element_size(), out_size, True)
    assert p.path != B
    xf = x.float()
    hh = torch.full((n, 1), float(h))
    mean = _row_sum(xf, p) / hh
    c = xf - mean
    rstd = torch.rsqrt(_row_sum(c * c, p) / hh + eps)
    y = c * rstd
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y.to(x.dtype).to(out_dtype)


def _fwd_inputs(shape, affine):
    rng = np.random.RandomState(sum(shape) + 7 * affine)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    if not affine:
        return x, None, None
    return (x, (1.0 + 0.1 * rng.randn(shape[1])).astype(np.float32),
            (0.1 * rng.randn(shape[1])).astype(np.float32))


@pytest.mark.parametrize("shape", [(6, 256), (5, 1001)])
@pytest.mark.parametrize("tin,tout", [("float32", "float32"),
                                      ("float32", "bfloat16"),
                                      ("bfloat16", "float32"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("affine", [True, False])
def test_register_fwd_model_matches_jax_kernel(shape, tin, tout, affine):
    x, w, b = _fwd_inputs(shape, affine)
    want = jax_norm.ln_fwd(jnp.asarray(x, _JAX[tin]),
                           None if w is None else jnp.asarray(w),
                           None if b is None else jnp.asarray(b), 1e-5,
                           interpret=True)
    want = np.asarray(want.astype(_JAX[tout]).astype(jnp.float32))
    got = register_ln_fwd_model(
        torch.from_numpy(x).to(_TORCH[tin]),
        None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), 1e-5, _TORCH[tout])
    assert got.dtype == _TORCH[tout] and got.shape == x.shape
    got = got.float().numpy()
    if "bfloat16" in (tin, tout):
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(6, 256), (5, 1001)])
def test_register_fwd_model_matches_the_plain_version(shape):
    """The model and the port's plain version (the card's yardstick) agree
    within the card check's fp32 tolerance (LN_RTOL: 1e-5 relative, 1e-5
    of the largest |y|)."""
    x, w, b = (torch.from_numpy(a) for a in _fwd_inputs(shape, True))
    got = register_ln_fwd_model(x, w, b, 1e-5, torch.float32)
    want = norm.ln_fwd_plain(x, w, b, 1e-5, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
