"""apex_tpu_torch.kernels.fused_cc family (a) against
apex_tpu.kernels.fused_cc on the CPU.

The GEMM ``_matmul`` (kernel #20 on the card; on CPU tensors its plain
version ``matmul_plain``) is held against JAX's ``_matmul`` with its
Pallas kernel run in interpret mode, the way ``tests/L0/test_fused_cc.py``
forces it, on shapes off the card's path: rows that are not a multiple of
8 (JAX pads them, the port guards its bounds), a 3-D x, a bf16 x with an
fp32 w, and a strided column slice of w (read in place). Then
``matmul_reduce_from`` (column tiles, one all-reduce each) forward and its
x / w gradients on a one-rank gloo group, against JAX's under a
one-device ``shard_map`` over the ``model`` axis, composed with
``copy_to`` as mesh2d composes them.

Tolerance: rtol 1e-5 (atol 1e-6 for entries near 0): both sides sum the
same fp32 products in their own order, over at most 48 terms here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.testing import shard_map
from apex_tpu.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region as jax_copy_to,
)
from apex_tpu_torch.kernels import fused_cc, registry
from apex_tpu_torch.parallel import register_axis
from apex_tpu_torch.transformer.tensor_parallel import (
    copy_to_tensor_model_parallel_region,
)
from torch_threads import one_torch_thread  # noqa: F401

AX = "model"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def interpret():
    kreg = get_kernel_registry()
    kreg.force_interpret(True)
    try:
        yield
    finally:
        kreg.force_interpret(False)


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    register_axis(AX, dist.group.WORLD)
    yield
    register_axis(AX, None)
    dist.destroy_process_group()


def _case(name):
    rng = np.random.RandomState(7)
    if name == "ragged_rows":
        return rng.randn(13, 24), rng.randn(24, 40), None
    if name == "one_row":
        return rng.randn(1, 24), rng.randn(24, 40), None
    if name == "3d_x":
        return rng.randn(2, 5, 24), rng.randn(24, 40), None
    if name == "bf16_x":
        return rng.randn(3, 7, 48), rng.randn(48, 33), "bf16"
    if name == "strided_w":  # a column tile of a wider matrix
        return rng.randn(16, 24), rng.randn(24, 64), slice(16, 48)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["ragged_rows", "one_row", "3d_x",
                                  "bf16_x", "strided_w"])
def test_matmul_matches_jax_interpret(interpret, case):
    x, w, extra = _case(case)
    x, w = x.astype(np.float32), w.astype(np.float32)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if extra == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    if isinstance(extra, slice):
        wj = wj[:, extra]
        wt = wt[:, extra]
        assert not wt.is_contiguous()
    want = np.asarray(jax_fused_cc._matmul(xj, wj))
    before = registry.launches()["tp_matmul"]
    got = fused_cc._matmul(xt, wt)
    assert registry.launches()["tp_matmul"] == before  # a CPU tensor
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused_cc.matmul_plain(xt, wt).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_col_tiles_match_jax():
    for n in (1, 3, 6, 7, 256, 1024, 4096):
        assert fused_cc._col_tiles(n) == jax_fused_cc._col_tiles(n)


@pytest.mark.parametrize("tiles", [4, 3])
def test_matmul_reduce_from_matches_jax_at_world1(interpret, world1, tiles):
    rng = np.random.RandomState(11)
    x = rng.randn(2, 5, 16).astype(np.float32)
    w = rng.randn(16, 24).astype(np.float32)
    dy = rng.randn(2, 5, 24).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), (AX,))

    def loss(xs, ws):
        out = jax_fused_cc.matmul_reduce_from(jax_copy_to(xs, AX), ws, AX,
                                              tiles)
        return jnp.sum(out * jnp.asarray(dy)), out

    def body(xs, ws):
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(xs, ws)
        return out, grads

    out_j, (dx_j, dw_j) = shard_map(body, mesh=mesh, in_specs=(P(), P(AX)),
                                    out_specs=(P(), (P(), P(AX))))(
        jnp.asarray(x), jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    calls = []
    real = dist.all_reduce

    def counted(t, *a, **k):
        calls.append(t.numel())
        return real(t, *a, **k)

    dist.all_reduce = counted
    try:
        out = fused_cc.matmul_reduce_from(
            copy_to_tensor_model_parallel_region(xt, AX), wt, AX, tiles)
    finally:
        dist.all_reduce = real
    (out * torch.from_numpy(dy)).sum().backward()
    t = fused_cc._col_tiles(24, tiles)
    assert calls == [2 * 5 * 24 // t] * t  # one all-reduce a tile at world 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=RTOL,
                               atol=ATOL)


def test_rings_take_the_plain_product_at_world1(world1):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 12).astype(np.float32))
    want = x @ w
    with torch.no_grad():
        assert torch.equal(fused_cc.matmul_reduce_scatter(x, w, AX), want)
        assert torch.equal(fused_cc.all_gather_matmul(x, w, AX), want)
        # jnp's promotion: a bf16 x against an fp32 w gives fp32
        xb = x.bfloat16()
        for ring in (fused_cc.matmul_reduce_scatter,
                     fused_cc.all_gather_matmul):
            assert torch.equal(ring(xb, w, AX), xb.float() @ w)
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_cc.all_gather_matmul(x.requires_grad_(), w, AX)
