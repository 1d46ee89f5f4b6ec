"""apex_tpu_torch.parallel.compression's collectives at world size 1
against apex_tpu.parallel.compression on the CPU.

The port runs on a one-rank gloo group (a FileStore under tmp_path); the
JAX side runs its collectives in ``shard_map`` over a one-device 'dp'
mesh. A one-rank group still runs every collective (the sum and the MAX
are the identity there, the reduce-scatter and gather copies), so what
is held here is the arithmetic around them; the cross-rank agreement is
held at world size 2 in test_torch_ddp_world2.py. Inputs come from numpy
seeds and go to both sides as the same values.

Tolerance: none. Sums, shards, gathers and residuals are compared bit for
bit: the same fp32 operations in the same order on both sides (at world
1 the bf16 sum is a cast there and back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import compression as jax_comp
from apex_tpu.testing import shard_map
from apex_tpu_torch.parallel import compression, groups, register_axis
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group for the port's collectives."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _jax(mesh, fn, *per_rank):
    """``fn`` on each rank's slice of ``per_rank`` ([world, ...] numpy
    arrays) in shard_map over the 'dp' axis; outputs stacked [world, ...]
    as numpy (None stays None)."""
    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda o: o[None], out)

    f = shard_map(body, mesh=mesh, in_specs=tuple(P("dp") for _ in per_rank),
                  out_specs=P("dp"))
    return jax.tree_util.tree_map(np.asarray,
                                  f(*[jnp.asarray(x) for x in per_rank]))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _data(seed, *shape, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("n", [1000, 768])
def test_psum_compressed_matches_jax(world1, dp_mesh, mode, with_residual,
                                     n):
    g = _data(n, n)
    r = _data(n + 1, n, scale=0.01) if with_residual else None
    if r is None:
        want = _jax(dp_mesh(1), lambda x: jax_comp.psum_compressed(
            x, "dp", mode=mode), g[None])
    else:
        want = _jax(dp_mesh(1), lambda x, y: jax_comp.psum_compressed(
            x, "dp", mode=mode, residual=y), g[None], r[None])
    out, res = compression.psum_compressed(
        torch.from_numpy(g), "dp", mode=mode,
        residual=None if r is None else torch.from_numpy(r))
    assert out.dtype == torch.float32 and tuple(out.shape) == (n,)
    _same(out, want[0][0])
    if mode == "bf16":
        assert res is None if r is None else res is not None
        if r is not None:
            _same(res, r)  # passed through
    else:
        assert res.dtype == torch.float32 and tuple(res.shape) == (n,)
        _same(res, want[1][0])
        # at world 1 the sum plus the new residual gives back g + r
        eff = g if r is None else g + r
        np.testing.assert_allclose((out + res).numpy(), eff, rtol=2 ** -23,
                                   atol=0)


@pytest.mark.parametrize("scale_mult", [None, 1.0 / 3.0])
def test_psum_compressed_blocks_matches_jax(world1, dp_mesh, scale_mult):
    x2d = _data(11, 6, 256)
    x2d[2] = 0.0
    want = _jax(dp_mesh(1), lambda x: jax_comp.psum_compressed_blocks(
        x, "dp", scale_mult=scale_mult), x2d[None])
    out, err = compression.psum_compressed_blocks(
        torch.from_numpy(x2d), "dp", scale_mult=scale_mult)
    _same(out, want[0][0])
    _same(err, want[1][0])
    assert tuple(err.shape) == (6, 256)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_psum_scatter_compressed_matches_jax(world1, dp_mesh, mode,
                                             with_residual):
    n = 4 * 256
    g = _data(21, n)
    r = _data(22, n, scale=0.01) if with_residual else None
    if r is None:
        want = _jax(dp_mesh(1), lambda x: jax_comp.psum_scatter_compressed(
            x, "dp", mode=mode), g[None])
    else:
        want = _jax(dp_mesh(1), lambda x, y: jax_comp.psum_scatter_compressed(
            x, "dp", mode=mode, residual=y), g[None], r[None])
    shard, res = compression.psum_scatter_compressed(
        torch.from_numpy(g), "dp", mode=mode,
        residual=None if r is None else torch.from_numpy(r))
    assert shard.dtype == torch.float32
    _same(shard, want[0][0])
    if mode != "bf16":
        _same(res, want[1][0])


@pytest.mark.parametrize("mode,block", [("bf16", 256), ("int8", 256),
                                        ("int4", 256), ("int8", 100),
                                        ("int4", 33)])
def test_all_gather_compressed_matches_jax(world1, dp_mesh, mode, block):
    shard = _data(31, 700)
    shard[:block] = 0.0  # an all-zero block
    want = _jax(dp_mesh(1), lambda x: jax_comp.all_gather_compressed(
        x, "dp", mode=mode, block_size=block), shard[None])
    got = compression.all_gather_compressed(torch.from_numpy(shard), "dp",
                                            mode=mode, block_size=block)
    assert got.dtype == torch.float32
    _same(got, want[0])


@pytest.mark.parametrize("block", [256, 33])
def test_int4_gather_matches_jax_fused_form(world1, dp_mesh, block):
    """JAX's default int4 gather, the fused ``fused_cc`` pair (here its
    Pallas kernels interpreted), bit for bit."""
    from apex_tpu.kernels import fused_cc as jax_fcc
    shard = _data(37, 900)
    shard[block:2 * block] = 0.0
    jax_fcc.GATE.force_interpret(True)
    try:
        want = _jax(dp_mesh(1), lambda x: jax_comp.all_gather_compressed(
            x, "dp", mode="int4", block_size=block), shard[None])
    finally:
        jax_fcc.GATE.force_interpret(False)
    got = compression.all_gather_compressed(torch.from_numpy(shard), "dp",
                                            mode="int4", block_size=block)
    _same(got, want[0])


def test_int4_gather_error_within_half_a_local_step(world1):
    """|y - x| <= s_eff / 2 with the shard's own two-level scales, the
    bound tests/L0/test_kernels.py holds JAX's int4 round trip to (its
    gather test holds the looser gmax / 7)."""
    from apex_tpu_torch.kernels import quant4
    x = torch.from_numpy(_data(41, 4 * 256))
    y = compression.all_gather_compressed(x, "dp", mode="int4")
    x2d = x.reshape(4, 256)
    s = quant4.effective_scales(*quant4.int4_block_scales(
        x2d.abs().amax(-1, keepdim=True).clamp_min(1e-12)))
    assert ((y.reshape(4, 256) - x2d).abs() <= s / 2).all()


@pytest.mark.parametrize("mode", [None, "bf16", "int8", "int4"])
@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("n", [406382592, 4198400, 1000])
def test_estimate_allreduce_bytes_matches_jax(mode, world, n):
    assert compression.estimate_allreduce_bytes(
        n, world=world, compress=mode) == jax_comp.estimate_allreduce_bytes(
        n, world=world, compress=mode)


def test_unknown_modes_are_refused(world1):
    x = torch.zeros(512)
    for fn in (compression.psum_compressed,
               compression.psum_scatter_compressed,
               compression.all_gather_compressed):
        with pytest.raises(ValueError, match="unknown compression"):
            fn(x, "dp", mode="int2")
    with pytest.raises(ValueError, match="unknown compression"):
        compression.estimate_allreduce_bytes(100, compress="int2")


def test_axis_names_resolve_to_groups(world1):
    assert groups.axis_group("dp") is dist.group.WORLD
    assert dist.get_world_size(groups.axis_group("dp")) == 1
    with pytest.raises(ValueError, match="names no process group"):
        compression.psum_compressed(torch.zeros(256), "tp", mode="int8")
    with pytest.raises(NotImplementedError, match="item 6"):
        groups.axis_group(("dp", "ep"))
    with pytest.raises(ValueError, match="default process group"):
        register_axis("dp", dist.group.WORLD)
    register_axis("data", dist.group.WORLD)
    try:
        out, _ = compression.psum_compressed(torch.ones(256), "data",
                                             mode="bf16")
        assert torch.equal(out, torch.ones(256))
    finally:
        register_axis("data", None)
    with pytest.raises(ValueError, match="names no process group"):
        groups.axis_group("data")


def test_no_group_names_initialize_distributed():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        compression.psum_compressed(torch.zeros(256), "dp", mode="int4")
