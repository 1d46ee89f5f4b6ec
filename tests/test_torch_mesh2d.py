"""apex_tpu_torch.parallel.mesh2d against apex_tpu.parallel.mesh2d on the
CPU, on test_mesh2d.py's small model (hidden 64, 2 layers, 4 heads, vocab
64, 16 positions, batches of 2 x 16 tokens a data row).

- ``gpt2_init`` draws JAX's parameters bit for bit; the partition dims
  and ``local_template`` are JAX's.
- ``gpt2_loss`` and every gradient, fused (kernel #20's plain version
  and a tile all-reduce each) and unfused, on a one-rank gloo group,
  against JAX's loss and ``jax.grad`` (unfused: the mesh axis unbound,
  its region ops the identity, as on one device).
- Three steps (the int8 or fp32 DP sync, SGD) on a 1 x 1 mesh in both
  modes, ``"baseline"`` (the full backward, then the bucketed sync) and
  ``"overlapped"`` (the segmented backward of ``OverlappedDataParallel``,
  the residual in the bucket domain; the default, as JAX's), fused on and
  off, against JAX's jitted ``build_train_step`` on ``mesh_2d(1, 1)``
  (the Pallas GEMM in interpret mode).
- Two steps on a 2 x 2 world of four gloo ranks from the port's
  launcher, against JAX's ``mesh_2d(2, 2)`` on four of the eight virtual
  devices: each rank's shards and its loss (its data row's batch).

Tolerances: the loss and gradients rtol 2e-5 (fp32 sums over up to 256
terms in another order; an absolute part of 2e-5 of each gradient's
largest entry for entries that cancel; the key biases' gradients vanish
analytically, since softmax ignores a shift common to a query's scores,
and are roundoff of ~1e-9 in both, held within 1e-7). Parameters after
the steps with an fp32 sync: rtol 2e-5, absolute 1e-6 (measured 1.2e-7
after three steps). With the int8 sync a gradient that lies within its
last fp32 places of a rounding boundary of its block's grid may take the
other code in the two packages; each such flip moves a parameter by lr x
its block's scale, at most lr x max|g| / 127 a step: the parameters are
held within that quantum times the steps taken (measured flips moved
them by up to 3e-5). Each rank has 120 s.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.parallel import mesh2d as jax_mesh2d
from apex_tpu_torch.models import from_jax_segments
from apex_tpu_torch.parallel import groups, mesh2d
from apex_tpu_torch.parallel.distributed import _leaves
from torch_threads import one_torch_thread  # noqa: F401

MODEL = dict(hidden=64, layers=2, heads=4, vocab=64, max_seq=16)
BATCH, SEQ, STEPS = 2, 16, 3
RTOL, PARAM_ATOL, GRAD_FLOOR = 2e-5, 1e-6, 1e-7
LR = 0.05  # build_train_step's default


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    for axis in (mesh2d.DATA_AXIS, mesh2d.MODEL_AXIS):
        groups.register_axis(axis, None)
    dist.destroy_process_group()


@pytest.fixture
def interpret():
    kreg = get_kernel_registry()
    kreg.force_interpret(True)
    try:
        yield
    finally:
        kreg.force_interpret(False)


def _jax_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def test_gpt2_init_is_jax_bit_for_bit():
    want = jax_mesh2d.gpt2_init(**MODEL)
    got = mesh2d.gpt2_init(**MODEL, device="cpu")
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, got))
    for g, w in zip(_leaves(got), _jax_leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    # from_jax_segments carries JAX's tree into the same layout
    carried = from_jax_segments(jax.tree_util.tree_map(np.asarray, want))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(carried),
                                                 _leaves(got)))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_partition_dims_and_local_template_match_jax(tp):
    full_j = jax_mesh2d.gpt2_init(**MODEL)
    full_t = mesh2d.gpt2_init(**MODEL, device="cpu")
    dims_j = jax.tree_util.tree_leaves(
        jax_mesh2d.gpt2_partition_dims(full_j), is_leaf=lambda x: x is None)
    dims_t = [d for d in _leaves_with_none(mesh2d.gpt2_partition_dims(
        full_t))]
    assert dims_t == dims_j
    local_j = _jax_leaves(jax_mesh2d.local_template(full_j, tp))
    local_t = _leaves(mesh2d.local_template(full_t, tp))
    assert [tuple(t.shape) for t in local_t] == [a.shape for a in local_j]
    assert not any(t.any() for t in local_t)
    # each shard is the JAX placement's slice along its partition dim
    for m in range(tp):
        shards = _leaves(mesh2d.shard_params(full_t, m, tp))
        for s, full, d in zip(shards, _leaves(full_t), dims_t):
            want = full if d is None else torch.chunk(full, tp, dim=d)[m]
            assert torch.equal(s, want)
    with pytest.raises(ValueError, match="does not split"):
        mesh2d.local_template(full_t, 5)


def _leaves_with_none(tree):
    """The leaves of a dims tree in jax.tree_util order, None included."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_none(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves_with_none(t)]
    return [tree]


def _batch(rows=BATCH, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, MODEL["vocab"], (rows, SEQ)),
            rng.randint(0, MODEL["vocab"], (rows, SEQ)))


@pytest.mark.parametrize("fused", [False, True])
def test_loss_and_every_gradient_match_jax(world1, fused):
    mesh2d.mesh_2d(1, 1)
    head_dim = MODEL["hidden"] // MODEL["heads"]
    full_j = jax_mesh2d.gpt2_init(**MODEL)
    tokens, labels = _batch()
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jax_mesh2d.gpt2_loss(p, jnp.asarray(tokens),
                                       jnp.asarray(labels), head_dim))(full_j)
    full_t = mesh2d.gpt2_init(**MODEL, device="cpu")
    leaves = [p.requires_grad_() for p in _leaves(full_t)]
    calls = []
    real = dist.all_reduce

    def counted(t, *a, **k):
        calls.append(t.numel())
        return real(t, *a, **k)

    dist.all_reduce = counted
    try:
        loss_t = mesh2d.gpt2_loss(full_t, torch.from_numpy(tokens),
                                  torch.from_numpy(labels), head_dim,
                                  fused=fused)
    finally:
        dist.all_reduce = real
    # fused: 4 tile all-reduces for each of the 2 x 2 row-parallel
    # projections; unfused: none (the region ops are the identity at 1)
    assert len(calls) == (16 if fused else 0), calls
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=RTOL)
    for g, w in zip(grads_t, _jax_leaves(grads_j)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=max(
            RTOL * np.abs(w).max(), GRAD_FLOOR))


def _close_params(got, want, what, atol=PARAM_ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=what)


def _int8_quantum(tokens, labels):
    """lr x the largest |g| / 127 at the initial parameters: the most one
    int8 code flip moves a parameter in a step."""
    tree = mesh2d.gpt2_init(**MODEL, device="cpu")
    full = [p.requires_grad_() for p in _leaves(tree)]
    loss = mesh2d.gpt2_loss(tree, torch.tensor(tokens),
                            torch.tensor(labels),
                            MODEL["hidden"] // MODEL["heads"])
    g = torch.autograd.grad(loss, full)
    return LR * max(t.abs().max().item() for t in g) / 127


@pytest.mark.parametrize("mode", ["baseline", "overlapped"])
@pytest.mark.parametrize("compress", ["int8", None])
@pytest.mark.parametrize("fused", [False, True])
def test_three_steps_on_a_1x1_mesh_match_jax(world1, interpret, fused,
                                             compress, mode):
    hidden, heads = MODEL["hidden"], MODEL["heads"]
    mesh_j = jax_mesh2d.mesh_2d(1, 1)
    step_j, (sp_j, res_j) = jax_mesh2d.build_train_step(
        mesh_j, jax_mesh2d.gpt2_init(**MODEL), hidden=hidden, heads=heads,
        mode=mode, fused=fused, compress=compress)
    tok_j, lab_j = jax_mesh2d.make_batch(mesh_j, batch_per_replica=BATCH,
                                         seq=SEQ, vocab=MODEL["vocab"])
    mesh = mesh2d.mesh_2d(1, 1)
    step, (sp, res) = mesh2d.build_train_step(
        mesh, mesh2d.gpt2_init(**MODEL, device="cpu"), hidden=hidden,
        heads=heads, mode=mode, fused=fused, compress=compress)
    tok, lab = mesh2d.make_batch(mesh, batch_per_replica=BATCH, seq=SEQ,
                                 vocab=MODEL["vocab"], device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    quantum = _int8_quantum(tok, lab) if compress else 0.0
    for k in range(STEPS):
        sp_j, res_j, loss_j = step_j(sp_j, res_j, tok_j, lab_j)
        sp, res, loss = step(sp, res, tok, lab)
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL,
                                   err_msg=f"step {k + 1}")
        _close_params([p.numpy() for p in _leaves(sp)], _jax_leaves(sp_j),
                      f"step {k + 1}", PARAM_ATOL + (k + 1) * quantum)
    if compress:  # error feedback carries a residual
        assert all(r.abs().sum() > 0 for r in _leaves(res))
        if mode == "overlapped":  # in the bucket domain, as JAX's
            assert [[tuple(r.shape) for r in s] for s in res] == [
                [r.shape for r in s] for s in res_j]
    else:
        assert res is None


def test_default_mode_is_overlapped_as_jax(world1):
    """mesh2d.build_train_step's default mode is JAX's, "overlapped": the
    residual comes back in the bucket domain."""
    import inspect

    want = inspect.signature(jax_mesh2d.build_train_step).parameters
    got = inspect.signature(mesh2d.build_train_step).parameters
    assert got["mode"].default == want["mode"].default == "overlapped"
    mesh = mesh2d.mesh_2d(1, 1)
    _, (_, res) = mesh2d.build_train_step(
        mesh, mesh2d.gpt2_init(**MODEL, device="cpu"), hidden=MODEL["hidden"],
        heads=MODEL["heads"])
    assert isinstance(res, tuple) and all(
        r.dim() == 2 and r.shape[1] == 256 for s in res for r in s)


def test_modes_waiting_for_later_items_raise(world1, interpret):
    """A 2 x 2 mesh needs four ranks; ``mode="guarded"`` (resilience) runs:
    the step armed by ``guard_nan_step`` is skipped with the shards and
    the residual bit for bit as before it, the steps around it commit,
    and the guard's counts and the parameters are JAX's guarded step's
    (fused, the int8 sync)."""
    with pytest.raises(ValueError, match="takes every rank"):
        mesh2d.mesh_2d(2, 2)
    hidden, heads = MODEL["hidden"], MODEL["heads"]
    mesh_j = jax_mesh2d.mesh_2d(1, 1)
    step_j, (sp_j, res_j, gst_j) = jax_mesh2d.build_train_step(
        mesh_j, jax_mesh2d.gpt2_init(**MODEL), hidden=hidden, heads=heads,
        mode="guarded", guard_nan_step=1, fused=True)
    tok_j, lab_j = jax_mesh2d.make_batch(mesh_j, batch_per_replica=BATCH,
                                         seq=SEQ, vocab=MODEL["vocab"])
    mesh = mesh2d.mesh_2d(1, 1)
    step, (sp, res, gst) = mesh2d.build_train_step(
        mesh, mesh2d.gpt2_init(**MODEL, device="cpu"), hidden=hidden,
        heads=heads, mode="guarded", guard_nan_step=1, fused=True)
    tok, lab = mesh2d.make_batch(mesh, batch_per_replica=BATCH, seq=SEQ,
                                 vocab=MODEL["vocab"], device="cpu")
    quantum = _int8_quantum(tok, lab)
    for k in range(STEPS):
        before = [p.clone() for p in _leaves(sp)] + [
            r.clone() for r in _leaves(res)]
        sp_j, res_j, gst_j, loss_j = step_j(sp_j, res_j, gst_j,
                                            jnp.int32(k), tok_j, lab_j)
        sp, res, gst, loss = step(sp, res, gst, torch.tensor(k), tok, lab)
        after = _leaves(sp) + _leaves(res)
        same = all(torch.equal(a, b) for a, b in zip(before, after))
        assert same == (k == 1), f"step {k}: skipped={same}"
        assert [int(v) for v in gst] == [int(v) for v in gst_j], k
        _close_params([p.numpy() for p in _leaves(sp)], _jax_leaves(sp_j),
                      f"step {k + 1}", PARAM_ATOL + (k + 1) * quantum)
    assert [int(v) for v in gst] == [0, 1, 0]


# --------------------------------------------------------- 2 x 2 world

WORLD = 4
WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import mesh2d
from apex_tpu_torch.parallel.distributed import _leaves
from apex_tpu_torch.parallel.multiproc import initialize_distributed

MODEL, BATCH, SEQ, STEPS = %(consts)r
initialize_distributed(device="cpu")  # the launcher's env
rank = dist.get_rank()
mesh = mesh2d.mesh_2d(2, 2)
assert (mesh.data_rank, mesh.model_rank) == divmod(rank, 2)
step, (sp, res) = mesh2d.build_train_step(
    mesh, mesh2d.gpt2_init(**MODEL, device="cpu"), hidden=MODEL["hidden"],
    heads=MODEL["heads"], mode="baseline", fused=True)
tok, lab = mesh2d.make_batch(mesh, batch_per_replica=BATCH, seq=SEQ,
                             vocab=MODEL["vocab"], device="cpu")
out = {}
for k in range(STEPS):
    sp, res, loss = step(sp, res, tok, lab)
    out[f"loss{k}"] = loss
for i, p in enumerate(_leaves(sp)):
    out[f"p{i}"] = p
np.savez(sys.argv[1] + f"/rank{rank}.npz",
         **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, steps):
    script = tmp_path / "worker.py"
    script.write_text(WORKER % dict(consts=(MODEL, BATCH, SEQ, steps)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nnodes", str(WORLD), "--node_rank", str(r), "--coordinator",
         f"127.0.0.1:{port}", str(script), str(tmp_path)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=120)
            assert p.returncode == 0 and f"RANK{r}_OK" in log, (
                f"rank {r} failed:\n{log}")
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]


def test_two_steps_on_a_2x2_world_match_jax(tmp_path, interpret):
    steps = 2
    got = _run_ranks(tmp_path, steps)
    hidden, heads = MODEL["hidden"], MODEL["heads"]
    head_dim = hidden // heads
    mesh_j = jax_mesh2d.mesh_2d(2, 2, devices=jax.devices()[:WORLD])
    step_j, (sp_j, res_j) = jax_mesh2d.build_train_step(
        mesh_j, jax_mesh2d.gpt2_init(**MODEL), hidden=hidden, heads=heads,
        mode="baseline", fused=True)
    tok_j, lab_j = jax_mesh2d.make_batch(mesh_j, batch_per_replica=BATCH,
                                         seq=SEQ, vocab=MODEL["vocab"])
    tokens, labels = np.asarray(tok_j), np.asarray(lab_j)
    for k in range(steps):
        # each data row's loss at the step's starting parameters (the
        # full arrays; JAX returns one row's)
        full = jax.tree_util.tree_map(np.asarray, sp_j)
        for r in range(WORLD):
            d = r // 2
            rows = slice(d * BATCH, (d + 1) * BATCH)
            want = jax_mesh2d.gpt2_loss(full, jnp.asarray(tokens[rows]),
                                        jnp.asarray(labels[rows]), head_dim)
            np.testing.assert_allclose(got[r][f"loss{k}"], float(want),
                                       rtol=RTOL, err_msg=f"rank {r} step {k}")
        sp_j, res_j, _ = step_j(sp_j, res_j, tok_j, lab_j)
    full = _jax_leaves(sp_j)
    quantum = _int8_quantum(tokens[:BATCH], labels[:BATCH])
    dims = jax.tree_util.tree_leaves(jax_mesh2d.gpt2_partition_dims(sp_j),
                                     is_leaf=lambda x: x is None)
    for r in range(WORLD):
        m = r % 2
        want = [w if d is None else np.split(w, 2, axis=d)[m]
                for w, d in zip(full, dims)]
        _close_params([got[r][f"p{i}"] for i in range(len(full))], want,
                      f"rank {r}", PARAM_ATOL + steps * quantum)
    # the data rows' replicas of a shard agree after the sync
    for i in range(len(full)):
        np.testing.assert_array_equal(got[0][f"p{i}"], got[2][f"p{i}"])
