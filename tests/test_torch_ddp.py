"""apex_tpu_torch.parallel.distributed (DistributedDataParallel, bucket
planning, the bucketed and per-leaf gradient sync, Reducer) against
apex_tpu.parallel.distributed on the CPU, at world size 1.

The port runs on a one-rank gloo group (a FileStore under tmp_path); the
JAX side runs ``DistributedDataParallel.sync`` in ``shard_map`` over a
one-device 'dp' mesh, on the same dict of gradients from numpy seeds.
``message_size`` is small enough to cut the dict into several buckets, so
the bucket plan (which leaves share a quantization grid) is held too.

Tolerances: the int modes, the bf16 payload and the fp32 sums are
compared bit for bit (the same fp32 operations in the same order; at
world 1 a sum is the identity). The module-wrapping mode's gradients
come from two frameworks' autodiff of the same small model: fp32 sums in
another order and two tanh implementations, rtol 1e-5 with an absolute
part of 1e-5 of the largest gradient (entries that cancel to ~0). The
200-step error-feedback convergence holds
JAX's own bound: the int4 loss within 2 % of the fp32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from apex_tpu import _C as jax_C
from apex_tpu.parallel import distributed as jax_ddp
from apex_tpu.testing import shard_map
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    Reducer,
    distributed,
    flatten,
    init_residual,
    plan_buckets,
    unflatten,
)
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"w0": (16, 32), "b0": (32,), "w1": (32, 8), "b1": (8,),
          "emb": (300, 7), "a": (5, 5), "z": (1000,)}
MESSAGE_SIZE = 600  # several buckets, "z" (1000) alone


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _grads(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 10 ** rng.uniform(-2, 1)).astype(dtype)
            for k, s in SHAPES.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax_sync(mesh, ddp, grads, residual):
    """``ddp.sync`` on one rank's dict (and residual dict), op by op (a
    jitted step may contract or reorder the fp32 operations), with the
    'dp' axis bound by ``vmap`` over the mesh's size: eager ``shard_map``
    compiles every operation anew, a vmapped operation once."""
    world = mesh.devices.size

    def body(g, r):
        if r is None and ddp.compress not in ("int8", "int4"):
            return ddp.sync(g)
        return ddp.sync(g, r)

    stack = lambda t: None if t is None else jax.tree_util.tree_map(  # noqa
        lambda x: jnp.broadcast_to(jnp.asarray(x), (world,) + x.shape), t)
    out = jax.vmap(body, axis_name="dp")(stack(grads), stack(residual))
    return jax.tree_util.tree_map(lambda o: np.asarray(o)[0], out)


def _same_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)


# ---------------------------------------------------------------- buckets

@pytest.mark.parametrize("sizes,cap", [
    ([10, 20, 30, 40], 50), ([100, 1, 1], 50), ([5, 60, 5, 5], 50),
    ([1] * 7, 3), ([50, 50], 50), ([], 10)])
def test_assign_buckets_matches_jax(sizes, cap):
    assert distributed.assign_buckets(sizes, cap) == list(
        jax_C.assign_buckets(sizes, cap))


def test_assign_buckets_refuses_cap_zero():
    for fn in (distributed.assign_buckets, jax_C.assign_buckets):
        with pytest.raises(ValueError):
            fn([1, 2], 0)


@pytest.mark.parametrize("message_size", [MESSAGE_SIZE, 100, 10000000])
def test_plan_buckets_matches_jax(message_size):
    g = _grads(0)
    dtypes = {"b0": np.float16, "a": np.float16}  # a second dtype group
    leaves_j = [jnp.asarray(g[k], dtypes.get(k, np.float32))
                for k in sorted(g)]
    leaves_t = [torch.from_numpy(g[k].astype(dtypes.get(k, np.float32)))
                for k in sorted(g)]
    assert plan_buckets(leaves_t, message_size) == jax_ddp.plan_buckets(
        leaves_j, message_size)


def test_flatten_refuses_mixed_dtypes_and_round_trips():
    with pytest.raises(ValueError, match="mixed dtypes"):
        flatten([torch.zeros(3), torch.zeros(2, dtype=torch.bfloat16)])
    ts = [torch.randn(3, 2), torch.randn(5)]
    back = unflatten(flatten(ts), ts)
    assert all(torch.equal(a, b) for a, b in zip(back, ts))


# ------------------------------------------------------------------- sync

@pytest.mark.parametrize("mode", [None, "bf16", "int8", "int4"])
@pytest.mark.parametrize("message_size", [MESSAGE_SIZE, None])
def test_sync_matches_jax_over_three_steps(world1, dp_mesh, mode,
                                           message_size):
    """Bucketed and per-leaf sync, the residual carried three steps."""
    mesh = dp_mesh(1)
    ddp_j = jax_ddp.DistributedDataParallel(
        axis_name="dp", message_size=message_size, compress=mode)
    ddp_t = DistributedDataParallel(axis_name="dp",
                                    message_size=message_size, compress=mode)
    stateful = mode in ("int8", "int4")
    res_j = res_t = None
    for step in range(3):
        g = _grads(step + 1)
        out_j = _jax_sync(mesh, ddp_j, g, res_j)
        out_t = ddp_t.sync(_to_torch(g), res_t)
        if stateful:
            (out_j, res_j), (out_t, res_t) = out_j, out_t
            _same_tree(res_t, res_j)
            assert all(torch.count_nonzero(r) for r in res_t.values())
        _same_tree(out_t, out_j)
        assert list(out_t) == list(g)  # the dict keeps its key order


@pytest.mark.parametrize("message_size", [MESSAGE_SIZE, None])
def test_bf16_grads_with_allreduce_always_fp32(world1, dp_mesh,
                                               message_size):
    g = _grads(7)
    g_bf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
    ddp_j = jax_ddp.DistributedDataParallel(
        axis_name="dp", message_size=message_size,
        allreduce_always_fp32=True)
    ddp_t = DistributedDataParallel(axis_name="dp",
                                    message_size=message_size,
                                    allreduce_always_fp32=True)
    want = _jax_sync(dp_mesh(1), ddp_j, g_bf, None)
    got = ddp_t.sync({k: torch.from_numpy(v).bfloat16()
                      for k, v in g.items()})
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    _same_tree(got, {k: np.asarray(v, np.float32) for k, v in want.items()})


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_gradient_predivide_factor(world1, dp_mesh, mode):
    ddp_j = jax_ddp.DistributedDataParallel(
        axis_name="dp", message_size=MESSAGE_SIZE, compress=mode,
        gradient_predivide_factor=2.0)
    ddp_t = DistributedDataParallel(axis_name="dp",
                                    message_size=MESSAGE_SIZE,
                                    compress=mode,
                                    gradient_predivide_factor=2.0)
    g = _grads(9)
    want = _jax_sync(dp_mesh(1), ddp_j, g, None)
    got = ddp_t.sync(_to_torch(g))
    if mode is not None:
        (want, res_j), (got, res_t) = want, got
        _same_tree(res_t, res_j)
    _same_tree(got, want)


def test_list_of_grads_keeps_its_order(world1):
    """A list flattens in its own order; the result is a list."""
    g = _grads(3)
    keys = list(SHAPES)[::-1]
    ddp = DistributedDataParallel(message_size=MESSAGE_SIZE, compress="int8")
    out, res = ddp.sync([torch.from_numpy(g[k]) for k in keys])
    assert isinstance(out, list) and len(out) == len(keys)
    for k, o, r in zip(keys, out, res):
        assert o.shape == torch.Size(SHAPES[k]) and r.dtype == torch.float32
    assert [r.shape for r in init_residual(out)] == [o.shape for o in out]


def test_reducer_matches_jax(world1, dp_mesh):
    g = _grads(4)
    want = _jax_sync(dp_mesh(1), jax_ddp.DistributedDataParallel(
        axis_name="dp", message_size=None), g, None)
    _same_tree(Reducer().reduce(_to_torch(g)), want)
    got = Reducer(axis_name="dp").reduce(_to_torch(g), compress="int8")
    _same_tree(got[0], _jax_sync(dp_mesh(1), jax_ddp.DistributedDataParallel(
        axis_name="dp", message_size=None, compress="int8"), g, None)[0])


# ------------------------------------------------- module-wrapping mode

def _loss_inputs():
    rng = np.random.RandomState(5)
    return (rng.randn(16, 8).astype(np.float32),
            rng.randn(8, 4).astype(np.float32),
            rng.randn(4).astype(np.float32))


def test_module_mode_averages_gradients_as_jax(world1, dp_mesh):
    x, w, b = _loss_inputs()

    def loss_j(params, xb):
        return jnp.sum(jnp.tanh(xb @ params["w"] + params["b"]) ** 2)

    ddp_j = jax_ddp.DistributedDataParallel(axis_name="dp")
    f = shard_map(lambda p, xb: jax.grad(ddp_j(loss_j))(p, xb),
                  mesh=dp_mesh(1), in_specs=(P(), P()), out_specs=P())
    want = f({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    lin = torch.nn.Linear(8, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    ddp = DistributedDataParallel(lin)
    torch.sum(torch.tanh(ddp(torch.from_numpy(x))) ** 2).backward()
    close(lin.weight.grad.numpy().T, want["w"])
    close(lin.bias.grad.numpy(), want["b"])

    # a bare function has no parameters to hook: refused, naming the
    # module form
    def fn(w_, b_, xb):
        return torch.sum(torch.tanh(xb @ w_ + b_) ** 2)

    with pytest.raises(TypeError, match="nn.Module"):
        DistributedDataParallel()(fn)
    with pytest.raises(TypeError, match="nn.Module"):
        DistributedDataParallel(fn)


def test_int4_error_feedback_converges_within_2pct(world1):
    """JAX's acceptance check (tests/L0/test_kernels.py:651) on the port:
    200 SGD steps with int4 sync and error feedback end within 2 % of the
    uncompressed loss."""
    rng = np.random.RandomState(1234)
    w_true = rng.randn(16, 1).astype(np.float32)
    x = torch.from_numpy(rng.randn(256, 16).astype(np.float32))
    y = x @ torch.from_numpy(w_true) + 0.1 * torch.from_numpy(
        rng.randn(256, 1).astype(np.float32))
    p0 = {"w0": rng.randn(16, 32).astype(np.float32) / 4,
          "b0": np.zeros(32, np.float32),
          "w1": rng.randn(32, 1).astype(np.float32) / 5,
          "b1": np.zeros(1, np.float32)}

    def train(compress):
        ddp = DistributedDataParallel(axis_name="dp", compress=compress)
        params = {k: torch.from_numpy(v.copy()).requires_grad_()
                  for k, v in p0.items()}
        residual = None
        for _ in range(200):
            h = torch.tanh(x @ params["w0"] + params["b0"])
            loss = torch.mean((h @ params["w1"] + params["b1"] - y) ** 2)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            if compress:
                grads, residual = ddp.sync(grads, residual)
            else:
                grads = ddp.sync(grads)
            with torch.no_grad():
                for k, p in params.items():
                    p -= 0.05 * grads[k]
        return loss.item()

    loss_fp32 = train(None)
    loss_int4 = train("int4")
    assert loss_int4 == pytest.approx(loss_fp32, rel=0.02), (
        loss_int4, loss_fp32)


def test_refusals_name_their_roadmap_items(world1, dp_mesh):
    """Expert parallelism (item 6) still raises; the telemetry knobs run:
    ``numerics=`` appends the grads/synced statistics, held to JAX's
    (counts and absmax exact, norms within 1e-6), and ``memory_report``
    measures nothing without a card (None)."""
    with pytest.raises(NotImplementedError, match="item 6"):
        DistributedDataParallel(expert_param_predicate=lambda p: True)
    with pytest.raises(NotImplementedError, match="item 6"):
        DistributedDataParallel(axis_name=("dp", "ep")).sync(
            {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="unknown compression"):
        DistributedDataParallel(compress="int2")
    from apex_tpu_torch.telemetry import numerics

    mesh = dp_mesh(1)
    g = _grads(7)
    g["b0"][:3] = 0.0
    for mode in (None, "int8"):
        ddp_j = jax_ddp.DistributedDataParallel(
            axis_name="dp", compress=mode, numerics=1)
        ddp_t = DistributedDataParallel(axis_name="dp", compress=mode,
                                        numerics=1)
        want = _jax_sync(mesh, ddp_j, g, None)[-1]
        got = numerics.stats_to_floats(ddp_t.sync(_to_torch(g))[-1])
        assert sorted(got) == sorted(want) == sorted(
            f"{pre}/{k}" for pre in ("grads", "synced") for k in g)
        for key, row in got.items():
            for field, v in row.items():
                w = float(getattr(want[key], field))
                if field in ("l2", "rms"):
                    assert v == pytest.approx(w, rel=1e-6), (key, field)
                else:
                    assert v == w, (mode, key, field, v, w)
    out, stats = distributed.all_reduce_gradients(_to_torch(g),
                                                  numerics=True)
    assert sorted(stats) == sorted(f"{p}/{k}" for p in ("grads", "synced")
                                   for k in g)
    assert DistributedDataParallel().memory_report(lambda: None) is None


def test_all_reduce_flag_and_broadcast(world1, dp_mesh):
    flag = torch.tensor(1.0)
    assert distributed.all_reduce_flag(flag).item() == 1.0
    assert distributed.all_reduce_flag(0.0, axis_name=None).item() == 0.0
    params = {"w": torch.randn(3, 3), "b": torch.randn(3)}
    before = {k: v.clone() for k, v in params.items()}
    assert distributed.broadcast_params(params) is params
    assert all(torch.equal(params[k], before[k]) for k in params)
    # an empty tuple of axes is JAX's single-replica no-op
    g = torch.randn(4)
    assert distributed._psum_with_policy(g, (), False, True, 1.0) is g
