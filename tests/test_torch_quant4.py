"""apex_tpu_torch.kernels.quant4 (int4 dual quantization and nibble
packing, unfused and fused) and the shared-scale and int32 routes of
kernels.quant, against the JAX package on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors.
The JAX side runs through its jnp oracle and through its Pallas kernels
(``apex_tpu/kernels/quant4.py`` #16-#19, ``fused_cc.py``'s
``quantize_pack_int4`` and ``unpack_dequantize_int4`` #23/#24,
``compression._quant_kernel`` and ``_dequant_kernel`` #14/#15) in
interpret mode. Inputs come from numpy seeds and go to both sides as the
same values.

Tolerance: none. Scales, codes, packed bytes and dequantized values are
compared bit for bit: the same fp32 operations (a max, IEEE divisions,
a product by 255, round half to even, clips, integer nibble arithmetic,
one product) in the same order on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import fused_cc as jax_fcc
from apex_tpu.kernels import quant4 as jax_q4
from apex_tpu.parallel import compression as jax_comp
from apex_tpu_torch.kernels import quant, quant4, registry
from apex_tpu_torch.parallel import compression
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(params=["oracle", "interpret"])
def jax_path(request):
    """Run the JAX side through its jnp oracle or its interpreted Pallas
    kernels (the ``interpret`` fixture idiom of tests/L0/test_kernels)."""
    jax_comp.force_interpret(request.param == "interpret")
    yield request.param
    jax_comp.force_interpret(False)


@pytest.fixture(params=["oracle", "interpret"])
def jax_fused_path(request):
    """JAX's fused int4 pair through its jnp oracle or its interpreted
    Pallas kernels (the ``fused_cc`` gate)."""
    jax_fcc.GATE.force_interpret(request.param == "interpret")
    yield request.param
    jax_fcc.GATE.force_interpret(False)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _blocks(seed, nb, b, zero_rows=()):
    x = (np.random.RandomState(seed).randn(nb, b) * 3).astype(np.float32)
    for r in zero_rows:
        x[r] = 0.0
    return x


def _absmax(x2d):
    return np.maximum(np.abs(x2d).max(-1, keepdims=True),
                      np.float32(1e-12)).astype(np.float32)


def _scales_both(x2d):
    absmax = _absmax(x2d)
    sq_j, gmax_j = jax_q4.int4_block_scales(jnp.asarray(absmax))
    sq_t, gmax_t = quant4.int4_block_scales(torch.from_numpy(absmax))
    return (sq_j, gmax_j, jax_q4.effective_scales(sq_j, gmax_j),
            sq_t, gmax_t, quant4.effective_scales(sq_t, gmax_t))


@pytest.mark.parametrize("nb,b", [(40, 256), (7, 33), (1, 256), (3, 2)])
def test_int4_kernels_match_jax(jax_path, nb, b):
    """#16-#19 and the scales, bit for bit, at the block width of the
    gradient path (256), an odd width (pack pads one lane a row), one
    row and the narrowest even width."""
    x = _blocks(nb * b, nb, b, zero_rows=(0,) if nb > 1 else ())
    sq_j, gmax_j, s_j, sq_t, gmax_t, s_t = _scales_both(x)
    assert sq_t.dtype == torch.uint8 and s_t.dtype == torch.float32
    _same(sq_t, sq_j)
    _same(gmax_t, gmax_j)
    _same(s_t, s_j)
    q_j = jax_q4.quantize_int4(jnp.asarray(x), s_j)
    q_t = quant4.quantize_int4(torch.from_numpy(x), s_t)
    assert q_t.dtype == torch.int8 and q_t.abs().max() <= 7
    _same(q_t, q_j)
    p_j = jax_q4.pack_int4(q_j)
    p_t = quant4.pack_int4(q_t)
    assert p_t.dtype == torch.uint8 and tuple(p_t.shape) == (nb, -(-b // 2))
    _same(p_t, p_j)
    u_j = jax_q4.unpack_int4(p_j, b)
    u_t = quant4.unpack_int4(p_t, b)
    _same(u_t, u_j)
    _same(u_t, q_t)  # pack then unpack is the identity on the codes
    _same(quant4.unpack_int4(p_t), jax_q4.unpack_int4(p_j))  # pad lane kept
    y_j = jax_q4.dequantize_int4(q_j, s_j)
    y_t = quant4.dequantize_int4(q_t, s_t)
    _same(y_t, y_j)
    # within half a step of the effective grid, zero rows exact
    assert (np.abs(y_t.numpy() - x) <= s_t.numpy() / 2 * (1 + 1e-6)).all()
    if nb > 1:
        assert (y_t[0] == 0).all()


@pytest.mark.parametrize("nb,b", [(40, 256), (7, 33), (1, 256), (3, 2)])
def test_fused_int4_kernels_match_jax(jax_fused_path, nb, b):
    """#23 and #24 bit for bit against JAX's fused pair, and against the
    port's unfused pairs they replace on the gather (an odd width pads
    one zero value a row, which ``n`` drops again)."""
    x = _blocks(nb + 2 * b, nb, b, zero_rows=(0,) if nb > 1 else ())
    _, _, s_j, _, _, s_t = _scales_both(x)
    xt = torch.from_numpy(x)
    p_j = jax_fcc.quantize_pack_int4(jnp.asarray(x), s_j)
    p_t = quant4.quantize_pack_int4(xt, s_t)
    assert p_t.dtype == torch.uint8 and tuple(p_t.shape) == (nb, -(-b // 2))
    _same(p_t, p_j)
    _same(p_t, quant4.pack_int4(quant4.quantize_int4(xt, s_t)))
    y_t = quant4.unpack_dequantize_int4(p_t, s_t, n=b)
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (nb, b)
    _same(y_t, jax_fcc.unpack_dequantize_int4(p_j, s_j, n=b))
    _same(y_t, quant4.dequantize_int4(quant4.unpack_int4(p_t, b), s_t))
    _same(quant4.unpack_dequantize_int4(p_t, s_t),  # pad lane kept
          jax_fcc.unpack_dequantize_int4(p_j, s_j))


def test_block_scales_all_zero_bucket():
    """A bucket of zeros: gmax floors at 1e-12, every sq at 255, every
    code 0 and every value exactly 0 in both packages."""
    x = np.zeros((4, 256), np.float32)
    sq_j, gmax_j, s_j, sq_t, gmax_t, s_t = _scales_both(x)
    _same(sq_t, sq_j)
    _same(gmax_t, gmax_j)
    _same(s_t, s_j)
    y = quant4.dequantize_int4(quant4.quantize_int4(torch.from_numpy(x),
                                                    s_t), s_t)
    assert torch.equal(y, torch.zeros_like(y))


def test_tiny_blocks_floor_at_sq_one():
    """A block far below the bucket's largest gets sq clipped up to 1,
    not 0 (no division by zero on the way back)."""
    x = _blocks(5, 3, 256)
    x[1] *= 1e-6
    sq_j, _, s_j, sq_t, _, s_t = _scales_both(x)
    assert sq_t[1, 0].item() == 1
    _same(sq_t, sq_j)
    _same(s_t, s_j)


def test_two_level_scales_match_jax():
    """The helpers the collectives share: each block's floored absmax and
    the scales derived from it, bit for bit against JAX's sequence."""
    x = _blocks(8, 6, 256, zero_rows=(2,))
    sq_j, gmax_j, s_j = _scales_both(x)[:3]
    absmax = quant4.block_absmax(torch.from_numpy(x))
    _same(absmax, _absmax(x))
    s_t, sq_t, gmax_t = quant4.two_level_scales(absmax)
    _same(s_t, s_j)
    _same(sq_t, sq_j)
    _same(gmax_t, gmax_j)


def test_dequantize_int4_on_int32_partials(jax_path):
    """int32 partial sums take the plain arithmetic in both packages."""
    q = np.random.RandomState(3).randint(-56, 57, (9, 256)).astype(np.int32)
    s = (np.abs(np.random.RandomState(4).randn(9, 1)) * 0.1).astype(
        np.float32)
    _same(quant4.dequantize_int4(torch.from_numpy(q), torch.from_numpy(s)),
          jax_q4.dequantize_int4(jnp.asarray(q), jnp.asarray(s)))


def test_nan_makes_its_bucket_nan(jax_path):
    """One NaN makes gmax NaN, so every effective scale and every
    dequantized value of the bucket is NaN in both packages (the codes a
    NaN gets are unspecified)."""
    x = _blocks(6, 5, 256)
    x[2, 17] = np.nan
    _, _, s_j, _, _, s_t = _scales_both(x)
    assert np.isnan(np.asarray(s_j)).all() and torch.isnan(s_t).all()
    y_j = jax_q4.dequantize_int4(jax_q4.quantize_int4(jnp.asarray(x), s_j),
                                 s_j)
    y_t = quant4.dequantize_int4(quant4.quantize_int4(torch.from_numpy(x),
                                                      s_t), s_t)
    assert np.isnan(np.asarray(y_j)).all() and torch.isnan(y_t).all()


@pytest.mark.parametrize("nb,b", [(37, 256), (5, 100)])
def test_int8_given_scales_match_jax_pallas(jax_path, nb, b):
    """#14 with given (shared) scales: ``quantize_rows(..., scales=)``
    against ``_quantize_pallas`` (interpreted) and ``_quantize_jnp``."""
    x = _blocks(nb + b, nb, b, zero_rows=(1,))
    scales = np.asarray(jax_comp.block_scales(jnp.asarray(x))) * np.float32(
        1.5)  # another replica's larger absmax
    if jax_path == "interpret":
        q_j = jax_comp._quantize_pallas(jnp.asarray(x), jnp.asarray(scales))
    else:
        q_j = jax_comp._quantize_jnp(jnp.asarray(x), jnp.asarray(scales))
    q_t, s_t = quant.quantize_rows(torch.from_numpy(x.reshape(1, -1)), b,
                                   torch.from_numpy(scales).reshape(1, nb, 1))
    _same(q_t.reshape(nb, b), q_j)
    _same(s_t.reshape(nb, 1), scales)
    q_b, s_b = jax_comp.quantize_blockwise(jnp.asarray(x.reshape(-1)), b,
                                           scales=jnp.asarray(scales))
    q_p, s_p = compression.quantize_blockwise(
        torch.from_numpy(x.reshape(-1)), b, scales=torch.from_numpy(scales))
    _same(q_p, q_b)
    _same(s_p, s_b)


@pytest.mark.parametrize("world", [1, 8])
def test_int8_dequantize_int32_matches_jax_pallas(jax_path, world):
    """#15 on int32 codes (a psum of ``world`` int8 code tensors) against
    ``_dequantize_pallas`` (interpreted) and ``_dequantize_jnp``."""
    rng = np.random.RandomState(world)
    q = rng.randint(-127, 128, (world, 33, 256)).sum(0).astype(np.int32)
    s = (np.abs(rng.randn(33, 1)) * 0.01).astype(np.float32)
    if jax_path == "interpret":
        want = jax_comp._dequantize_pallas(jnp.asarray(q), jnp.asarray(s))
    else:
        want = jax_comp._dequantize_jnp(jnp.asarray(q), jnp.asarray(s))
    got = quant.dequantize_rows(torch.from_numpy(q)[None],
                                torch.from_numpy(s)[None])
    _same(got.reshape(33, 256), want)


def test_plain_versions_count_no_launch():
    registry.reset()
    x = torch.randn(4, 256)
    s = quant4.effective_scales(*quant4.int4_block_scales(
        x.abs().amax(-1, keepdim=True)))
    q = quant4.quantize_int4(x, s)
    quant4.dequantize_int4(q, s)
    quant4.unpack_int4(quant4.pack_int4(q))
    quant4.unpack_dequantize_int4(quant4.quantize_pack_int4(x, s), s)
    quant.quantize_rows(x, 256, s.reshape(4, 1, 1))
    assert not any(registry.launches()[k] for k in (
        "quantize_int4", "dequantize_int4", "pack_int4", "unpack_int4",
        "quantize_pack_int4", "unpack_dequantize_int4", "quantize_int8"))
