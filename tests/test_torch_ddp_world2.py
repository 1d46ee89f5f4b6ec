"""apex_tpu_torch's compressed collectives and DistributedDataParallel
across two real processes, against JAX's shard_map over a two-device
'dp' mesh.

The port's launcher starts two gloo ranks over 127.0.0.1::

    python -m apex_tpu_torch.parallel.multiproc --nnodes 2 --node_rank R \\
        --coordinator 127.0.0.1:PORT worker.py OUT

Each rank makes its own inputs from numpy seeds (seed 100 + rank; the
worker gets this file's ``inputs``), runs
``psum_compressed`` (bf16, int8, int4, with a residual), the int8 and
int4 ``psum_scatter_compressed``, the int4 ``all_gather_compressed`` and
``DistributedDataParallel(compress="int4").sync`` over two steps, and
three steps of the resilience guard (``guarded_update`` with the flag OR'd
over the ranks, rank 1's gradients poisoned at step 1: both ranks skip
it, as JAX's guard over the two-device mesh does), and writes its results
under OUT. This test then runs JAX on the same inputs.
World size 1 hides cross-rank faults (a MAX or a sum is the identity
there); here a wrong rank slice, an int8 MAX taken of absmaxes instead of
scales, or int4 scales derived before the MAX would show.

Tolerances: the int modes bit for bit (the codes sum exactly as int32;
every rank agrees on one grid); bf16 within 2**-8 relative, since the two
libraries may add a bf16 pair at different widths before rounding. Each
rank has 120 s, so a hang fails the test and not the suite's clock.
"""

import inspect
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import compression as jax_comp
from apex_tpu.parallel import distributed as jax_ddp
from apex_tpu.resilience import guard as jax_guard
from apex_tpu.testing import shard_map
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
N = 1000           # ragged: 4 blocks of 256, the last 232 lanes
SCATTER_N = 1024   # 4 blocks: 2 a rank
SHAPES = {"w": (24, 20), "b": (20,), "e": (50, 7)}
MESSAGE_SIZE = 400  # "w" (480) alone, then "b" and "e"

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import DistributedDataParallel, compression
from apex_tpu_torch.parallel.multiproc import initialize_distributed

N, SCATTER_N, SHAPES = %(sizes)r
%(inputs)s
initialize_distributed(device="cpu")  # the launcher's env
rank = dist.get_rank()
assert dist.get_world_size() == 2, dist.get_world_size()
x = {k: torch.from_numpy(v) for k, v in inputs(rank).items()}
out = {}
for mode in ("bf16", "int8", "int4"):
    s, r = compression.psum_compressed(x["g"], "dp", mode=mode,
                                       residual=x["r"])
    out[f"psum_{mode}"] = s
    if mode != "bf16":
        out[f"psum_{mode}_res"] = r
for mode in ("int8", "int4"):
    s, r = compression.psum_scatter_compressed(x["flat"], "dp", mode=mode)
    out[f"scatter_{mode}"], out[f"scatter_{mode}_res"] = s, r
out["gather_int4"] = compression.all_gather_compressed(x["shard"], "dp",
                                                       mode="int4")
ddp = DistributedDataParallel(message_size=%(message_size)d,
                              compress="int4")
res = None
for step in range(2):
    grads = {k: x[f"step{step}_{k}"] for k in %(keys)r}
    grads, res = ddp.sync(grads, res)
    for k in grads:
        out[f"ddp{step}_{k}"], out[f"ddp{step}_{k}_res"] = grads[k], res[k]
from apex_tpu_torch.resilience import guarded_update, init_guard_state
state, gst = {"w": torch.ones(5)}, init_guard_state()
for step in range(3):
    g = torch.full((5,), 0.5 * (rank + 1) + step)
    if (rank, step) == (1, 1):
        g[2] = float("nan")
    state, gst = guarded_update(
        {"w": g}, lambda gr, st, flag: {"w": st["w"] - 0.1 * gr["w"]},
        state, gst, axis_name="dp")
    out[f"guard_w{step}"] = state["w"].clone()
    out[f"guard_g{step}"] = torch.stack(list(gst))
np.savez(sys.argv[1] + f"/rank{rank}.npz",
         **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def inputs(rank):
    """Rank ``rank``'s inputs, from numpy seed 100 + rank."""
    rng = np.random.RandomState(100 + rank)

    def f32(*shape, scale=3.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x = {"g": f32(N), "r": f32(N, scale=0.01), "flat": f32(SCATTER_N),
         "shard": f32(512)}
    for step in range(2):
        for k, shape in SHAPES.items():
            x[f"step{step}_{k}"] = f32(*shape, scale=10.0 ** (rank - 1))
    return x


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER % dict(
        message_size=MESSAGE_SIZE, keys=tuple(SHAPES),
        sizes=(N, SCATTER_N, SHAPES), inputs=inspect.getsource(inputs)))
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


def _jax(mesh, fn, stacked):
    """``fn`` on each rank's slice of ``stacked`` (a dict of [world, ...]
    arrays) in shard_map over 'dp'; outputs stacked [world, ...]."""
    def body(xs):
        out = fn(jax.tree_util.tree_map(lambda a: a[0], xs))
        return jax.tree_util.tree_map(lambda o: o[None], out)

    f = shard_map(body, mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"))
    return jax.tree_util.tree_map(
        np.asarray, f(jax.tree_util.tree_map(jnp.asarray, stacked)))


def test_two_gloo_ranks_match_jax_shard_map(tmp_path, dp_mesh):
    got = _run_ranks(tmp_path)
    per_rank = [inputs(r) for r in range(WORLD)]
    stacked = {k: np.stack([x[k] for x in per_rank]) for k in per_rank[0]}
    mesh = dp_mesh(WORLD)

    def collectives(x):
        out = {}
        for mode in ("bf16", "int8", "int4"):
            s, r = jax_comp.psum_compressed(x["g"], "dp", mode=mode,
                                            residual=x["r"])
            out[f"psum_{mode}"] = s
            if mode != "bf16":
                out[f"psum_{mode}_res"] = r
        for mode in ("int8", "int4"):
            s, r = jax_comp.psum_scatter_compressed(x["flat"], "dp",
                                                    mode=mode)
            out[f"scatter_{mode}"], out[f"scatter_{mode}_res"] = s, r
        out["gather_int4"] = jax_comp.all_gather_compressed(
            x["shard"], "dp", mode="int4")
        return out

    want = _jax(mesh, collectives, stacked)
    ddp = jax_ddp.DistributedDataParallel(axis_name="dp",
                                          message_size=MESSAGE_SIZE,
                                          compress="int4")
    res = None
    for step in range(2):
        def sync(x, res=res, step=step):
            grads = {k: x[f"step{step}_{k}"] for k in SHAPES}
            r = None if res is None else {k: x[f"res_{k}"] for k in SHAPES}
            return ddp.sync(grads, r)

        if res is not None:
            stacked.update({f"res_{k}": v for k, v in res.items()})
        grads, res = _jax(mesh, sync, stacked)
        for k in SHAPES:
            want[f"ddp{step}_{k}"], want[f"ddp{step}_{k}_res"] = (
                grads[k], res[k])

    def guard(x):
        rank, state = x["rank"], {"w": jnp.ones(5)}
        gst, out = jax_guard.init_guard_state(), {}
        for step in range(3):
            g = jnp.full((5,), 0.5 * (rank + 1) + step)
            g = g.at[2].set(jnp.where((rank == 1) & (step == 1), jnp.nan,
                                      g[2]))
            state, gst = jax_guard.guarded_update(
                {"w": g}, lambda gr, st: {"w": st["w"] - 0.1 * gr["w"]},
                state, gst, axis_name="dp")
            out[f"guard_w{step}"] = state["w"]
            out[f"guard_g{step}"] = jnp.stack(list(gst))
        return out

    # jitted: the guard's few fp32 operations compile once, not op by op
    body = shard_map(
        lambda xs: jax.tree_util.tree_map(
            lambda o: o[None], guard(jax.tree_util.tree_map(
                lambda a: a[0], xs))),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp"))
    want.update(jax.tree_util.tree_map(np.asarray, jax.jit(body)(
        {"rank": jnp.arange(WORLD, dtype=jnp.float32)})))
    for r in range(WORLD):
        # one rank's NaN skipped the step on both
        np.testing.assert_array_equal(got[r]["guard_w1"], got[r]["guard_w0"])
        assert list(got[r]["guard_g1"]) == [1, 1, 1]
        assert set(got[r]) == set(want), sorted(set(got[r]) ^ set(want))
        for k, w in want.items():
            if k == "psum_bf16":
                np.testing.assert_allclose(got[r][k], w[r], rtol=2 ** -8,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got[r][k], w[r],
                                              err_msg=f"rank {r} {k}")
    # the ranks agree on the sums and hold their own residuals and shards
    np.testing.assert_array_equal(got[0]["psum_int4"], got[1]["psum_int4"])
    assert not np.array_equal(got[0]["scatter_int8"], got[1]["scatter_int8"])
    assert got[0]["scatter_int4"].shape == (SCATTER_N // WORLD,)
