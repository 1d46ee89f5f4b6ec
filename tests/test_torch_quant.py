"""apex_tpu_torch's int8 block core (parallel/compression over
kernels/quant) against apex_tpu.parallel.compression on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors.
The JAX side runs its public functions both through its jnp oracle and
through its Pallas kernels (``_quant_kernel``, ``_dequant_kernel``) in
interpret mode. Inputs come from numpy seeds and go to both sides as the
same values.

Tolerance: none. Codes, scales and dequantized values are compared bit
for bit: the same fp32 operations (a max, one IEEE division for the
scale and one per value, round half to even, one product) in the same
order on both sides. The streaming dequantize body's plan, a model of
its index math (held to JAX's jnp oracle) and its path codes are checked
here too.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.parallel import compression as jax_comp
from apex_tpu_torch.kernels import quant, registry
from apex_tpu_torch.parallel import compression
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(params=["oracle", "interpret"])
def jax_path(request):
    """Run the JAX side through its jnp oracle or its interpreted
    Pallas kernels."""
    jax_comp.force_interpret(request.param == "interpret")
    yield request.param
    jax_comp.force_interpret(False)


def _flat(seed, n, zero_block=None, block=256):
    x = np.random.RandomState(seed).randn(n).astype(np.float32) * 3.0
    if zero_block is not None:
        x[zero_block * block:(zero_block + 1) * block] = 0.0
    return x


def _ties(block):
    """A block with absmax 127 (scale exactly 1.0) holding values at
    k + 0.5, which round half to even (2.5 -> 2, -3.5 -> -4)."""
    x = np.zeros(block, np.float32)
    x[0] = 127.0
    halves = np.arange(block - 1, dtype=np.float32) % 20 - 10 + 0.5
    x[1:] = halves
    return x


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n,zero_block", [
    (1024, None), (1000, None),  # ragged tail: 1000 = 3 blocks + 232
    (768, 1), (37, None)])       # an all-zero block; less than a block
def test_quantize_blockwise_matches_jax(jax_path, n, zero_block):
    x = _flat(n, n, zero_block)
    q_j, s_j = jax_comp.quantize_blockwise(jnp.asarray(x))
    q_t, s_t = compression.quantize_blockwise(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(q_t.shape) == q_j.shape and tuple(s_t.shape) == s_j.shape
    _same(q_t, q_j)
    _same(s_t, s_j)
    out_j = jax_comp.dequantize_blockwise(q_j, s_j, n)
    out_t = compression.dequantize_blockwise(q_t, s_t, n)
    assert tuple(out_t.shape) == (n,)
    _same(out_t, out_j)
    if zero_block is not None:  # zeros, not NaN
        blk = out_t[zero_block * 256:(zero_block + 1) * 256]
        assert torch.equal(blk, torch.zeros_like(blk))


def test_ties_round_half_to_even(jax_path):
    x = np.concatenate([_ties(256), _flat(3, 256)])
    q_j, s_j = jax_comp.quantize_blockwise(jnp.asarray(x))
    q_t, s_t = compression.quantize_blockwise(torch.from_numpy(x))
    assert s_t[0, 0].item() == 1.0
    _same(q_t, q_j)
    _same(s_t, s_j)
    want = np.round(x[1:256]).astype(np.int8)  # numpy rounds half to even
    _same(q_t[0, 1:], want)
    assert q_t[0, 1].item() == -10 and q_t[0, 4].item() == -6  # -9.5, -6.5


@pytest.mark.parametrize("shape,block", [
    ((16, 3, 256), 256), ((16, 3, 100), 32),  # ragged rows: 100 = 3*32 + 4
    ((5, 2, 64), 64), ((7, 300), 256)])
def test_rows_blockwise_matches_jax(jax_path, shape, block):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    x[0, ...] = 0.0  # an all-zero row
    q_j, s_j = jax_comp.quantize_rows_blockwise(jnp.asarray(x), block)
    q_t, s_t = compression.quantize_rows_blockwise(torch.from_numpy(x),
                                                   block)
    assert tuple(q_t.shape) == q_j.shape and tuple(s_t.shape) == s_j.shape
    _same(q_t, q_j)
    _same(s_t, s_j)
    n = shape[-1]
    out_j = jax_comp.dequantize_rows_blockwise(q_j, s_j, n=n)
    out_t = compression.dequantize_rows_blockwise(q_t, s_t, n=n)
    _same(out_t, out_j)
    # every lane within half a grid step of its block's absmax
    blocks = -(-n // block)
    pad = np.pad(x.reshape(-1, n), ((0, 0), (0, blocks * block - n)))
    amax = np.abs(pad.reshape(-1, blocks, block)).max(-1, keepdims=True)
    err = np.abs(np.pad((out_t.numpy() - x).reshape(-1, n),
                        ((0, 0), (0, blocks * block - n)))
                 ).reshape(-1, blocks, block)
    assert (err <= amax / 254.0 + 1e-7).all()
    # the full-width form keeps the zero-padded tail
    full_t = compression.dequantize_rows_blockwise(q_t, s_t)
    _same(full_t, jax_comp.dequantize_rows_blockwise(q_j, s_j))


def test_bf16_rows_and_bf16_output_match_jax(jax_path):
    """The KV cache's path: bf16 K/V rows in (JAX widens them to fp32
    first), dequantized rows out in bf16 (JAX casts the fp32 product)."""
    x = np.random.RandomState(9).randn(12, 256).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x, jnp.bfloat16)
    q_j, s_j = jax_comp.quantize_rows_blockwise(xj, 256)
    q_t, s_t = compression.quantize_rows_blockwise(xb, 256)
    _same(q_t, q_j)
    _same(s_t, s_j)
    out_j = jax_comp.dequantize_rows_blockwise(q_j, s_j, n=256).astype(
        jnp.bfloat16)
    out_t = compression.dequantize_rows_blockwise(q_t, s_t, n=256,
                                                  out_dtype=torch.bfloat16)
    assert out_t.dtype == torch.bfloat16
    _same(out_t.float(), np.asarray(out_j.astype(jnp.float32)))


def test_pad_and_block_helpers_match_jax():
    x = _flat(11, 300)
    _same(compression.pad_to_blocks(torch.from_numpy(x), 128),
          jax_comp.pad_to_blocks(jnp.asarray(x), 128))
    assert compression.num_blocks(300, 128) == jax_comp.num_blocks(300, 128)
    assert compression.BLOCK_SIZE == jax_comp.BLOCK_SIZE == 256
    x2 = _flat(12, 512).reshape(2, 256)
    _same(compression.block_scales(torch.from_numpy(x2)),
          jax_comp.block_scales(jnp.asarray(x2)))


def test_int32_payload_dequantizes_on_the_cpu():
    """JAX's dequantize takes the int32 partial sums of the collectives;
    the plain version does too (the kernel takes int8 only)."""
    q = np.random.RandomState(13).randint(-500, 500, (3, 256)).astype(
        np.int32)
    s = np.full((3, 1), 0.01, np.float32)
    _same(compression.dequantize_blockwise(torch.from_numpy(q),
                                           torch.from_numpy(s)),
          jax_comp.dequantize_blockwise(jnp.asarray(q), jnp.asarray(s)))


def test_plain_versions_count_no_launch():
    registry.reset()
    x = torch.randn(4, 300)
    q, s = quant.quantize_rows(x, 256)
    quant.dequantize_rows(q, s, 300)
    launches = registry.launches()
    assert launches["quantize_int8"] == 0
    assert launches["dequantize_int8"] == 0


# ----------------------------------------------------------------------
# The streaming dequantize (csrc/quant8.cu `dequant_vec_kernel`): its plan,
# a model of its index math, its path codes and its C signature.

_CU = Path(quant.__file__).resolve().parent.parent / "csrc" / "quant8.cu"


@pytest.mark.parametrize("code,out", [(1, 2), (1, 4), (4, 4), (4, 2)])
def test_dequant_plan_streams_whole_rows(code, out):
    """int8 and int32 codes into bf16 and fp32: the serving cache's
    [16384, 1, 256] rows and a DDP bucket (one row, ragged or not) take
    the vector body."""
    assert quant.dequant_plan(16384, 256, 1, 256, code, out, True) == \
        quant.VECTOR
    assert quant.dequant_plan(999, 512, 2, 256, code, out, True) == \
        quant.VECTOR
    assert quant.dequant_plan(1, 1000, 4, 256, code, out, True) == \
        quant.VECTOR
    assert quant.dequant_plan(1, 51_511_296, 201_216, 256, code, out,
                              True) == quant.VECTOR


def test_dequant_plan_keeps_the_first_design_elsewhere():
    """Ragged rows (n < nb * block with rows > 1), a block that is not a
    power of two or holds less than a 16-byte code vector, and codes off
    a 16-byte boundary (a view at +4 bytes) take the first design."""
    assert quant.dequant_plan(999, 300, 2, 256, 1, 4, True) == quant.SCALAR
    assert quant.dequant_plan(64, 1000, 10, 100, 1, 4, True) == quant.SCALAR
    assert quant.dequant_plan(8, 16, 2, 8, 1, 2, True) == quant.SCALAR
    assert quant.dequant_plan(8, 16, 8, 2, 4, 4, True) == quant.SCALAR
    assert quant.dequant_plan(8, 32, 8, 4, 4, 4, True) == quant.VECTOR
    buf = torch.zeros(16 * 256 + 16, dtype=torch.int8)
    view = buf[4:4 + 16 * 256].view(16, 1, 256)
    assert buf.data_ptr() % 16 == 0 and view.data_ptr() % 16 == 4
    assert quant.dequant_plan(16, 256, 1, 256, 1, 2,
                              view.data_ptr() % 16 == 0) == quant.SCALAR
    # the wrapper's CPU path on that view still gives the plain values
    s = torch.rand(16, 1, 1)
    _same(quant.dequantize_rows(view, s, 256),
          quant.dequantize_rows_plain(view.contiguous(), s, 256))


def _vector_model(q, scales, n, out_dtype):
    """dequant_vec_kernel's index math on the CPU: the codes as one flat
    array of 16-byte vectors, vector i's elements e = i * V .. e + V - 1
    scaled by block e >> log2(block), one fp32 product each (rounded to
    bf16 where asked), written up to the rows' n elements (the last
    vector of a ragged one-row call element by element)."""
    rows, nb, block = q.shape
    per = 16 // q.element_size()
    flat, s = q.reshape(-1), scales.reshape(-1)
    total = rows * n
    out = torch.empty(total, dtype=out_dtype)
    shift = block.bit_length() - 1
    for i in range(-(-total // per)):
        e = i * per
        v = flat[e:e + per].float() * s[e >> shift]
        k = min(per, total - e)
        out[e:e + k] = v[:k].to(out_dtype)
    return out.reshape(rows, n)


@pytest.mark.parametrize("rows,nb,n,codes", [
    (12, 1, 256, "int8"), (5, 3, 768, "int32"), (1, 4, 1000, "int8"),
    (1, 4, 1001, "int32"), (1, 1, 37, "int8")])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_vector_index_math_matches_jax(rows, nb, n, codes, out_dtype):
    """The model, on numpy-seeded codes and scales, bit for bit against
    JAX's ``_dequantize_jnp`` (a one-row call with a ragged n included)."""
    rng = np.random.RandomState(rows * 1000 + n)
    hi = 127 if codes == "int8" else 5000
    q = rng.randint(-hi, hi + 1, (rows, nb, 256)).astype(codes)
    s = (rng.rand(rows, nb, 1) * 0.1).astype(np.float32)
    tq, ts = torch.from_numpy(q), torch.from_numpy(s)
    td = getattr(torch, out_dtype)
    assert quant.dequant_plan(rows, n, nb, 256, tq.element_size(),
                              td.itemsize, True) == quant.VECTOR
    got = _vector_model(tq, ts, n, td)
    want = jax_comp._dequantize_jnp(jnp.asarray(q.reshape(-1, 256)),
                                    jnp.asarray(s.reshape(-1, 1)))
    want = want.reshape(rows, nb * 256)[:, :n].astype(getattr(jnp, out_dtype))
    _same(got.float(), np.asarray(want.astype(jnp.float32)))
    _same(got.float(), quant.dequantize_rows_plain(tq, ts, n, td).float())


def test_dequant_path_codes_match_the_kernel_source():
    """apex_dequant8's paths: 0 the first design, 1 the streaming body, 2
    and 3 its planted faults (the neighbouring block's scale; each vector
    read one ahead); the vector is 16 bytes."""
    src = _CU.read_text()
    assert "if (path < 0 || path > 3) return -1;" in src
    assert "return launch_vec<C, O, kNoFault>(" in src
    assert re.search(r"if \(path == 2\)\s+return launch_vec<C, O, "
                     r"kNeighbourScale>", src)
    assert re.search(r"if \(path == 3\)\s+return launch_vec<C, O, "
                     r"kReadAhead>", src)
    assert "constexpr int V = 16 / sizeof(C);" in src
    assert quant.VECTOR_BYTES == 16 and (quant.SCALAR, quant.VECTOR) == (0, 1)


# ----------------------------------------------------------------------
# The streaming quantize (csrc/quant8.cu `quant_vec_kernel`): its plan, a
# model of its cell and lane index math, packing and division, and its
# path codes.

@pytest.mark.parametrize("itemsize", [2, 4])
def test_quant_plan_streams_whole_rows(itemsize):
    """bf16 and fp32 rows whose blocks are contiguous in the codes: the
    serving store's admission and decode rows, blocks of 32 and 256, a
    one-row DDP bucket with or without a ragged tail, and the largest
    block a lane group holds (32 * 4 vectors)."""
    per = 16 // itemsize
    for rows, n, nb, block in [(16384, 256, 1, 256), (8, 256, 1, 256),
                               (999, 512, 2, 256), (1000, 96, 3, 32),
                               (1, 1000, 4, 256), (1, 1001, 4, 256),
                               (1, 51_511_296, 201_216, 256),
                               (3, 128 * per, 1, 128 * per),
                               (3, 4 * per, 4, per)]:
        assert quant.quant_plan(rows, n, nb, block, itemsize, True) == \
            quant.VECTOR, (rows, n, block)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_quant_plan_keeps_the_first_design_elsewhere(itemsize):
    """Ragged rows (n < nb * block with rows > 1), a block of 100 (not a
    power of two), a block holding less than one 16-byte vector or more
    than 4 a lane, other itemsizes, and operands off a 16-byte boundary
    (a view at +4 bytes) take the first design."""
    per = 16 // itemsize
    assert quant.quant_plan(999, 300, 2, 256, itemsize, True) == \
        quant.SCALAR
    assert quant.quant_plan(64, 1000, 10, 100, itemsize, True) == \
        quant.SCALAR
    assert quant.quant_plan(8, per, 2, per // 2, itemsize, True) == \
        quant.SCALAR
    assert quant.quant_plan(8, 256 * per, 1, 256 * per, itemsize,
                            True) == quant.SCALAR
    assert quant.quant_plan(8, 256, 1, 256, 8, True) == quant.SCALAR
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    buf = torch.zeros(16 * 256 + 8, dtype=dtype)
    view = buf[4 // itemsize:4 // itemsize + 16 * 256].view(16, 256)
    assert buf.data_ptr() % 16 == 0 and view.data_ptr() % 16 == 4
    assert quant.quant_plan(16, 256, 1, 256, itemsize,
                            view.data_ptr() % 16 == 0) == quant.SCALAR
    # the wrapper's CPU path on that view still gives the plain values
    q, s = quant.quantize_rows(view, 256)
    qp, sp = quant.quantize_rows_plain(view.contiguous(), 256)
    assert torch.equal(q, qp) and torch.equal(s, sp)


_ROUND = 12582912.0  # 1.5 * 2^23: y + _ROUND rounds y to an integer


def _vector_codes(vals, scale, clip):
    """quant8.cu's vector_codes on fp32 vectors vals [..., V] with their
    scales [..., 1]: y = vals * RN(1 / scale) (clipped to +-127 for given
    scales), rounded by adding 1.5 * 2^23, whose low byte is the code,
    where the reciprocal is a normal float and no y of the vector lies
    within 2^-14 of a half-integer; else code() for the whole vector:
    clip(rint(vals / scale)) (IEEE division, round half to even). NaN
    clips to -127, as fminf / fmaxf do."""
    lo, hi = torch.tensor(-quant.QMAX), torch.tensor(quant.QMAX)
    inv = torch.ones_like(scale) / scale
    fast = (inv >= torch.finfo(torch.float32).tiny) & \
        (inv <= torch.finfo(torch.float32).max)
    y = vals * inv
    if clip:
        y = torch.fmin(torch.fmax(y, lo), hi)
    t = y + _ROUND
    near = (y - (t - _ROUND)).abs().amax(-1, keepdim=True) >= 0.5 - 2.0 ** -14
    quick = (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
    slow = torch.fmin(torch.fmax(torch.round(vals / scale), lo), hi)
    return torch.where(fast & ~near, quick, slow.to(torch.int8))


def _quant_vector_model(x2d, block, scales=None):
    """quant_vec_kernel's index math and arithmetic on the CPU. x2d's
    rows are contiguous in the codes' order: x is one flat array of
    16-byte vectors (V values), vector i at element e = i * V read (zeros
    past the ragged tail of a one-row call). A slab is 32 * kVPL vectors,
    kVPL = max(1, block / (32 V)); lane l of a warp holds vectors slab *
    32 kVPL + u * 32 + l (u < kVPL) and takes the cell of its vector u = 0;
    the cell's group of min(32, block / V) lanes reduces the absmax of
    its values (an integer max of their |x| bits). The scale is
    max(absmax, 1e-12) / 127 (or the given one); each vector's V codes
    (_vector_codes) are packed little-endian into 32-bit words and stored
    at q + e. Returns (q [rows, nb, block], scales [rows, nb, 1])."""
    rows, n = x2d.shape
    per = 16 // x2d.element_size()
    nb = -(-n // block)
    stored = rows * nb * block
    flat = torch.zeros(stored)
    flat[:rows * n] = x2d.reshape(-1).float()  # the padded vectors read 0
    vpl = max(1, block // (32 * per))
    lanes = min(32, block // per)
    nvec = stored // per
    slab_vecs = 32 * vpl
    shift = block.bit_length() - 1
    vec = flat.reshape(nvec, per)
    q = torch.zeros(stored, dtype=torch.int8)
    out_scales = torch.zeros(stored >> shift)
    for slab in range(-(-nvec // slab_vecs)):
        i0 = slab * slab_vecs + torch.arange(32)  # each lane's u = 0
        live = i0 < nvec
        cells = (i0 * per) >> shift
        idx = torch.stack([i0 + 32 * u for u in range(vpl)], 1)  # [32, vpl]
        vals = vec[idx.clamp(max=nvec - 1)] * live[:, None, None]
        if scales is None:  # an integer max of |x|'s bits
            bits = (vals.view(torch.int32) & 0x7FFFFFFF).amax((1, 2))
            bits = bits.reshape(32 // lanes, lanes).amax(1, keepdim=True)
            amax = bits.expand(-1, lanes).reshape(32).view(torch.float32)
            scale = torch.clamp_min(amax, 1e-12) / torch.full_like(
                amax, quant.QMAX)
            out_scales[cells[live]] = scale[live]
        else:
            scale = scales.reshape(-1)[cells.clamp(max=stored // block - 1)]
        codes = _vector_codes(vals, scale[:, None, None].expand(
            32, vpl, 1), scales is not None)
        words = codes.to(torch.uint8).to(torch.int64).reshape(32, vpl, -1, 4)
        words = (words << torch.tensor([0, 8, 16, 24])).sum(-1)
        words = words.to(torch.uint32).to(torch.int32)  # little-endian
        for lane in range(32):
            for u in range(vpl):
                i = int(idx[lane, u])
                if i < nvec:
                    q[i * per:(i + 1) * per] = words[lane, u].view(torch.int8)
    got_scales = (scales.reshape(-1) if scales is not None else out_scales)
    return q.reshape(rows, nb, block), got_scales.reshape(rows, nb, 1)


def _near_halves(rs, n, scale):
    """Values whose quotient by ``scale`` lies at k + 0.5 or one ulp of x
    off it: the division cases of the streaming body."""
    k = rs.randint(-120, 120, n).astype(np.float32) + np.float32(0.5)
    x = k * np.float32(scale)
    wiggle = rs.randint(-1, 2, n)  # one ulp down, none, one ulp up
    off = np.nextafter(x, np.where(wiggle > 0, np.inf, -np.inf))
    return np.where(wiggle == 0, x, off).astype(np.float32)


@pytest.mark.parametrize("rows,n,block,dtype,given", [
    (12, 256, 256, "bfloat16", False),   # the serving rows, 8 codes a vector
    (6, 512, 256, "float32", False),     # 2 vectors a lane, 4 codes each
    (40, 96, 32, "bfloat16", False),     # 4 lanes a cell, 8 cells a warp
    (3, 1024, 1024, "bfloat16", False),  # 4 vectors a lane
    (1, 1000, 256, "float32", False),    # one row, ragged tail
    (1, 1001, 256, "bfloat16", False),   # the tail past a vector's end
    (1, 1000, 256, "float32", True),     # given scales, ragged tail
    (10, 256, 64, "bfloat16", True)])
def test_quant_vector_model_matches_jax(rows, n, block, dtype, given):
    """The model, on numpy-seeded values (an all-zero block, a block at
    scale 1.0 with ties at k + .5, values within an ulp of k + .5 of
    their scale), bit for bit against JAX's ``block_scales`` and
    ``_quantize_jnp`` and against the plain version."""
    rs = np.random.RandomState(rows * 7 + n + block)
    x = (rs.randn(rows, n) * 3.0).astype(np.float32)
    x.reshape(-1)[:block] = 0.0  # an all-zero block
    if rows * n >= 3 * block:
        x.reshape(-1)[block:2 * block] = _ties(block)
        x.reshape(-1)[2 * block:3 * block] = _near_halves(rs, block, 0.0625)
        x.reshape(-1)[2 * block] = 127 * 0.0625  # that block's scale
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x, jdt).astype(jnp.float32)
    nb = -(-n // block)
    padded = jnp.pad(xj, ((0, 0), (0, nb * block - n))).reshape(-1, block)
    scales_j = jax_comp.block_scales(padded)
    given_t = None
    if given:
        scales_j = scales_j * 1.5
        given_t = torch.from_numpy(np.array(scales_j)).reshape(rows, nb, 1)
    q_j = jax_comp._quantize_jnp(padded, scales_j)
    assert quant.quant_plan(rows, n, nb, block, xt.element_size(),
                            True) == quant.VECTOR
    q, s = _quant_vector_model(xt, block, given_t)
    _same(q.reshape(-1, block), q_j)
    _same(s.reshape(-1, 1), scales_j)
    qp, sp = quant.quantize_rows_plain(xt, block, given_t)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("per", [4, 8])
def test_quant_fast_division_is_exact_near_every_half(per):
    """vector_codes on vectors of 4 and 8 values against the IEEE division
    (JAX's ``_quantize_jnp``): quotients at k + .5 and one ulp of x off
    it, k + .5 in [-119.5, 119.5], for scales across 40 binades, random
    quotients and quotients past the clip, as given scales would have
    them."""
    rs = np.random.RandomState(per)
    for scale in (2.0 ** rs.uniform(-30, 10, 64)).astype(np.float32):
        x = np.concatenate([_near_halves(rs, 4096, scale),
                            (rs.randn(4096) * 60 * scale).astype(np.float32),
                            (rs.randn(256) * 200 * scale).astype(np.float32)])
        s = np.full((x.size, 1), scale, np.float32)
        want = jax_comp._quantize_jnp(jnp.asarray(x[:, None]),
                                      jnp.asarray(s))
        got = _vector_codes(torch.from_numpy(x.reshape(-1, per)),
                            torch.from_numpy(s.reshape(-1, per)[:, :1]),
                            clip=True)
        _same(got.reshape(-1, 1), want)


def test_rounding_the_product_alone_misses_near_halves():
    """Why vector_codes falls back to the division near a half-integer:
    rounding RN(x * RN(1 / scale)) alone (the 1.5 * 2^23 add, no
    fallback) differs from JAX's codes on quotients at and one ulp off
    k + .5."""
    rs = np.random.RandomState(8)
    missed = 0
    for scale in (2.0 ** rs.uniform(-30, 10, 16)).astype(np.float32):
        x = _near_halves(rs, 4096, scale)
        s = np.full((x.size, 1), scale, np.float32)
        want = np.asarray(jax_comp._quantize_jnp(jnp.asarray(x[:, None]),
                                                 jnp.asarray(s)))
        t = torch.from_numpy(x) * (1 / torch.from_numpy(s[:, 0])) + _ROUND
        quick = (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)
        missed += int((quick.numpy() != want[:, 0]).sum())
    assert missed > 0


def test_quant_path_codes_match_the_kernel_source():
    """apex_quant8's paths: 0 the first design, 1 the streaming body, 2
    its fault on computed scales (the absmax without the cell's last
    vector), 3 on given ones (the neighbouring cell's scale); a lane holds
    at most QUANT_MAX_VECTORS_PER_LANE vectors of a cell; the division's
    shortcut's threshold is 2^-14 and its rounding constant 1.5 * 2^23."""
    src = _CU.read_text()
    assert "int dtype, int given, int path, void* stream) {" in src
    assert "if (path < 0 || path > 3) return -1;" in src
    assert re.search(r"if \(given && path == 1\)\s+return launch_quant_vec<"
                     r"T, true, kVPL, kNoFault>", src)
    assert re.search(r"if \(given && path == 3\)\s+return launch_quant_vec<"
                     r"T, true, kVPL, kNeighbourGiven>", src)
    assert re.search(r"if \(!given && path == 1\)\s+return "
                     r"launch_quant_vec<T, false, kVPL, kNoFault>", src)
    assert re.search(r"if \(!given && path == 2\)\s+return "
                     r"launch_quant_vec<T, false, kVPL, kShortAbsmax>", src)
    assert (f"constexpr int kMaxVPL = {quant.QUANT_MAX_VECTORS_PER_LANE};"
            in src)
    assert "near < 0.5f - 0x1p-14f" in src
    assert "constexpr float kRound = 12582912.f;" in src
