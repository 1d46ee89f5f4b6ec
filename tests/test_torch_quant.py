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
order on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.parallel import compression as jax_comp
from apex_tpu_torch.kernels import quant, registry
from apex_tpu_torch.parallel import compression


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
