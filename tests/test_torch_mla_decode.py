"""apex_tpu_torch.contrib.mla_decode (the MLA latent decode's plain
version, which the wrapper takes for CPU tensors) against apex_tpu's
Pallas kernel in interpret mode on the CPU, and the tile ladder that
decides the model's branch.

Inputs come from numpy seeds. Tolerance: 2e-6 absolute, as the JAX
package's own kernel tests (fp32 scores, softmax and sums in another
order; unit-scale inputs, outputs convex combinations of cache rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import mla_decode as jax_md
from apex_tpu.kernels.registry import choose_block as jax_choose_block
from apex_tpu_torch.contrib import mla_decode
from apex_tpu_torch.kernels import registry


@pytest.fixture(autouse=True)
def _interpret():
    jax_md.force_interpret(True)
    yield
    jax_md.force_interpret(False)


def _inputs(seed, b, n, L, T, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, L).astype(np.float32)
    cache = rng.randn(T, b, L).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ((jnp.asarray(q, jd), jnp.asarray(cache, jd)),
            (torch.from_numpy(q).to(td), torch.from_numpy(cache).to(td)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("length", [1, 7, 16, 33, 48])
def test_plain_version_matches_the_interpreted_kernel(length, dtype):
    b, n, lat, rope, T = 2, 8, 32, 8, 48
    (qj, cj), (qt, ct) = _inputs(length, b, n, lat + rope, T, dtype)
    want = jax_md.mla_flash_decode(qj, cj, jnp.int32(length), lat, 0.3,
                                   block_t=16)
    got = mla_decode.mla_flash_decode(qt, ct, length, lat, 0.3)
    assert got.dtype == torch.float32 and got.shape == (b, n, lat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dead_rows_are_invisible(dtype):
    """Rows at or past ``length`` holding 1e4 leave the result as it is."""
    b, n, lat, T, length = 2, 4, 16, 32, 10
    (qj, cj), (qt, ct) = _inputs(5, b, n, lat + 4, T, dtype)
    poisoned = ct.clone()
    poisoned[length:] = 1e4
    want = jax_md.mla_flash_decode(qj, cj.at[length:].set(1e4),
                                   jnp.int32(length), lat, 0.5, block_t=8)
    got = mla_decode.mla_flash_decode(qt, poisoned, length, lat, 0.5)
    clean = mla_decode.mla_flash_decode(qt, ct, length, lat, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), rtol=0,
                               atol=2e-6)


def test_per_row_lengths_are_each_rows_own():
    """A [b] length tensor gives each row what its own host length gives."""
    (_, _), (qt, ct) = _inputs(6, 3, 4, 24, 40, "float32")
    lengths = torch.tensor([1, 17, 40])
    got = mla_decode.mla_flash_decode(qt, ct, lengths, 16, 0.2)
    for r, n in enumerate(lengths.tolist()):
        want = mla_decode.mla_flash_decode(qt[r:r + 1], ct[:, r:r + 1], n,
                                           16, 0.2)
        torch.testing.assert_close(got[r:r + 1], want, rtol=0, atol=0)


@pytest.mark.parametrize("length", [0, -1, "row0", "scalar0"])
def test_a_length_below_one_is_refused_on_every_device(length):
    """With no live row the kernel (as JAX's) writes 0 and the plain version
    averages the whole buffer: the wrapper takes neither."""
    (_, _), (qt, ct) = _inputs(5, 2, 4, 24, 16, "float32")
    if length == "row0":
        length = torch.tensor([0, 3], dtype=torch.int32)
    elif length == "scalar0":
        length = torch.tensor(0)
    registry.reset()
    with pytest.raises(ValueError, match="must be >= 1"):
        mla_decode.mla_flash_decode(qt, ct, length, 16, 0.2)
    assert registry.launches()["mla_decode"] == 0


@pytest.mark.parametrize("cache_len", [40, 512, 600, 1280, 4608, 4100])
def test_tile_ladder_matches_jax(cache_len):
    assert (mla_decode.choose_block(cache_len, 512)
            == jax_choose_block(cache_len, 512))
    assert mla_decode.use_flash(cache_len) == jax_md.use_flash(cache_len)


def test_cpu_tensors_count_no_launch():
    (_, _), (qt, ct) = _inputs(7, 1, 2, 12, 8, "float32")
    registry.reset()
    mla_decode.mla_flash_decode(qt, ct, 3, 8, 0.4)
    assert registry.launches()["mla_decode"] == 0


def test_split_rows_fill_the_card_in_whole_tiles():
    """The path's step (b 8, 16 heads, a 4608-row cache on 132 SMs): 32
    chunks of 144 rows, 256 blocks; a chunk is whole tiles and the chunks
    cover the cache."""
    assert mla_decode.split_rows(4608, 8, 16, 132) == (144, 32)
    for T, b, n in ((1, 1, 1), (1024, 8, 16), (600, 2, 128), (4608, 1, 16)):
        chunk, splits = mla_decode.split_rows(T, b, n, 132)
        assert chunk % mla_decode.ROWS_PER_TILE == 0
        assert chunk * splits >= T > chunk * (splits - 1)
