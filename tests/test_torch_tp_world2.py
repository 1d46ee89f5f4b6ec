"""apex_tpu_torch's tensor parallelism across two real processes, against
JAX's shard_map over a two-device 'tp' mesh.

The port's launcher starts two gloo ranks over 127.0.0.1::

    python -m apex_tpu_torch.parallel.multiproc --nnodes 2 --node_rank R \\
        --coordinator 127.0.0.1:PORT worker.py OUT

Each rank calls ``initialize_model_parallel(2)`` and makes its inputs
with this file's ``inputs`` (shared weights from numpy seed 300, cut to
the rank's shard; the rank's own activations and cotangents from seed
200 + rank), then runs, forward and backward: the seven region ops
(``gather_from_sequence_parallel_region`` both ways), Column x Row
against a dense product, ``gather_output``, the sequence-parallel column,
``VocabParallelEmbedding`` with ids outside the table, the vocab-parallel
cross entropy with label smoothing and -100 and = vocab labels, and the
fused family (a) of ``kernels/fused_cc`` at g = 2 (and its refusal of
rows that g does not divide, as JAX's); it writes its results
under OUT. This test runs JAX's functions on the same per-rank inputs in
``shard_map`` (the Pallas GEMM in interpret mode) and holds the two.

The worker also counts the elements each form hands the collectives, by
patching ``torch.distributed`` there: under the ring model (an all-reduce
of E moves 2(g-1)/g E a rank, a reduce-scatter of E (g-1)/g E, an
all-gather of a shard E (g-1) E, a send E), each fused form moves exactly
what its unfused form moves.

Tolerances: rtol 2e-6 with an absolute part of 1e-6 of the array's
largest magnitude (at least 1e-6), for entries that cancel: the two
libraries sum at most 16 fp32 products, or exponentials, in their own
orders; two ranks' sums are exact either way. Each rank has 120 s.
"""

import inspect
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.testing import shard_map
from apex_tpu.transformer import parallel_state as jax_ps
from apex_tpu.transformer import tensor_parallel as jax_tp
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
RTOL, ATOL = 2e-6, 1e-6
VOCAB, EMB = 16, 8

WORKER = r"""
import sys
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.kernels import fused_cc
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp

%(inputs)s
initialize_distributed(device="cpu")  # the launcher's env
rank = dist.get_rank()
grid = ps.initialize_model_parallel(2)
assert grid.tolist() == [[[0, 1]]], grid
assert ps.get_tensor_model_parallel_world_size() == 2
assert ps.get_tensor_model_parallel_rank() == rank
assert ps.get_data_parallel_world_size() == 1
assert ps.get_tensor_model_parallel_src_rank() == 0
x = inputs(rank)
T = {k: torch.from_numpy(v) for k, v in x.items()}
out = {}


def run(name, fn, args, dy):
    args = [T[a].clone().requires_grad_() for a in args]
    y = fn(*args)
    y.backward(T[dy])
    out[name] = y.detach()
    for i, a in enumerate(args):
        out[f"{name}_d{i}"] = a.grad


run("copy", tp.copy_to_tensor_model_parallel_region, ["copy"], "copy_dy")
run("reduce", tp.reduce_from_tensor_model_parallel_region, ["reduce"],
    "reduce_dy")
run("scatter", tp.scatter_to_tensor_model_parallel_region, ["scatter"],
    "scatter_dy")
run("gather", tp.gather_from_tensor_model_parallel_region, ["gather"],
    "gather_dy")
run("sp_scatter", tp.scatter_to_sequence_parallel_region, ["sp_scatter"],
    "sp_scatter_dy")
run("sp_reduce_scatter", tp.reduce_scatter_to_sequence_parallel_region,
    ["sp_reduce_scatter"], "sp_reduce_scatter_dy")
for flag in (True, False):
    run(f"sp_gather_{flag}",
        lambda a: tp.gather_from_sequence_parallel_region(a, flag),
        ["sp_gather"], "sp_gather_dy")

# Column x Row, gather_output, the sequence-parallel column
col = tp.ColumnParallelLinear(8, 16, gather_output=False, device="cpu")
row = tp.RowParallelLinear(16, 8, input_is_parallel=True, device="cpu")
gat = tp.ColumnParallelLinear(8, 16, bias=False, gather_output=True,
                              device="cpu")
spc = tp.ColumnParallelLinear(8, 16, bias=False, gather_output=False,
                              sequence_parallel_enabled=True, device="cpu")
emb = tp.VocabParallelEmbedding(16, 8, device="cpu")
with torch.no_grad():
    col.weight.copy_(T["wc"]); col.bias.copy_(T["bc"])
    row.weight.copy_(T["wr"]); row.bias.copy_(T["br"])
    gat.weight.copy_(T["wc"]); spc.weight.copy_(T["wc"])
    emb.weight.copy_(T["table"])
assert tuple(col.weight.shape) == (8, 8) and tuple(row.weight.shape) == (8, 8)
for name, mod in (("col", col), ("row", row), ("gat", gat), ("spc", spc),
                  ("emb", emb)):
    mod.zero_grad()
run("colrow", lambda a: row(col(a)), ["lin_x"], "lin_dy")
for n, p in (("wc", col.weight), ("bc", col.bias), ("wr", row.weight),
             ("br", row.bias)):
    out[f"colrow_{n}"] = p.grad
run("gat", gat, ["lin_x"], "gat_dy")
out["gat_wc"] = gat.weight.grad
run("spc", spc, ["sp_x"], "spc_dy")
out["spc_wc"] = spc.weight.grad
y = emb(T["ids"])
y.backward(T["emb_dy"])
out["emb"], out["emb_table"] = y.detach(), emb.weight.grad
for ls in (0.0, 0.1):
    run(f"xent_{ls}", lambda a: tp.vocab_parallel_cross_entropy(
        a, T["target"], label_smoothing=ls), ["logits"], "xent_dy")

# family (a) at g = 2, and the elements handed to the collectives
counts = defaultdict(float)
real = {k: getattr(dist, k) for k in ("all_reduce", "reduce_scatter_tensor",
                                      "all_gather", "batch_isend_irecv")}
label = [None]


def all_reduce(t, *a, **k):
    counts[label[0]] += 2 * (2 - 1) / 2 * t.numel()
    return real["all_reduce"](t, *a, **k)


def reduce_scatter_tensor(o, t, *a, **k):
    counts[label[0]] += (2 - 1) / 2 * t.numel()
    return real["reduce_scatter_tensor"](o, t, *a, **k)


def all_gather(parts, t, *a, **k):
    counts[label[0]] += (2 - 1) * t.numel()
    return real["all_gather"](parts, t, *a, **k)


def batch_isend_irecv(ops):
    counts[label[0]] += sum(op.tensor.numel() for op in ops
                            if op.op.__name__ == "isend")
    return real["batch_isend_irecv"](ops)


def counted(name, fn):
    label[0] = name
    for k, f in (("all_reduce", all_reduce),
                 ("reduce_scatter_tensor", reduce_scatter_tensor),
                 ("all_gather", all_gather),
                 ("batch_isend_irecv", batch_isend_irecv)):
        setattr(dist, k, f)
    try:
        return fn()
    finally:
        for k, f in real.items():
            setattr(dist, k, f)


xa = T["mrf_x"].clone().requires_grad_()
wa = T["mrf_w"].clone().requires_grad_()
y = counted("reduce_from_fused", lambda: fused_cc.matmul_reduce_from(
    tp.copy_to_tensor_model_parallel_region(xa), wa, "tp"))
y.backward(T["mrf_dy"])
out["mrf"], out["mrf_dx"], out["mrf_dw"] = y.detach(), xa.grad, wa.grad
counted("reduce_from_unfused", lambda: tp.reduce_from_tensor_model_parallel_region(
    T["mrf_x"] @ T["mrf_w"]))
with torch.no_grad():
    out["mrs"] = counted("scatter_fused", lambda: fused_cc.matmul_reduce_scatter(
        T["mrs_x"], T["mrs_w"], "tp"))
    counted("scatter_unfused",
            lambda: tp.reduce_scatter_to_sequence_parallel_region(
                T["mrs_x"] @ T["mrs_w"]))
    out["agm"] = counted("gather_fused", lambda: fused_cc.all_gather_matmul(
        T["agm_x"], T["mrs_w"], "tp"))
    counted("gather_unfused", lambda: tp.gather_from_sequence_parallel_region(
        T["agm_x"]) @ T["mrs_w"])
    try:  # 5 rows do not split over 2 ranks
        fused_cc.matmul_reduce_scatter(T["mrs_x"][:5], T["mrs_w"], "tp")
        out["mrs_ragged_refused"] = torch.tensor(False)
    except ValueError:
        out["mrs_ragged_refused"] = torch.tensor(True)
for k, v in counts.items():
    out[f"count_{k}"] = torch.tensor(v)

# the tp source's batch, the random streams, the sequence-parallel grads
b = tp.broadcast_data(["a"], {"a": T["copy"]}, torch.float32)
out["bcast"] = b["a"]
tp.model_parallel_seed(1234, device="cpu")
tracker = tp.get_rng_state_tracker()
with tracker.fork() as g:
    out["rng_mp"] = torch.rand(4, generator=g)
with tracker.fork("default") as g:
    out["rng_default"] = torch.rand(4, generator=g)
grads = tp.allreduce_sequence_parallel_grads(
    {"ln": {"g": T["copy"][0]}, "w": T["copy"][1]},
    lambda name: name.startswith("ln"))
out["sp_grad_ln"], out["sp_grad_w"] = grads["ln"]["g"], grads["w"]
ps.destroy_model_parallel()
np.savez(sys.argv[1] + f"/rank{rank}.npz",
         **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def inputs(rank):
    """Rank ``rank``'s inputs: its shards of the shared weights (numpy
    seed 300) and its own activations and cotangents (seed 200 + rank)."""
    shared = np.random.RandomState(300)
    own = np.random.RandomState(200 + rank)

    def f(rng, *shape):
        return rng.randn(*shape).astype(np.float32)

    wc, bc = f(shared, 8, 16), f(shared, 16)
    wr, br = f(shared, 16, 8), f(shared, 8)
    table = f(shared, 16, 8)
    lin_x = f(shared, 2, 8)
    h = slice(8 * rank, 8 * (rank + 1))
    x = {"wc": wc[:, h], "bc": bc[h], "wr": wr[h], "br": br,
         "table": table[h]}
    for name, shape, dy in (("copy", (4, 6), (4, 6)),
                            ("reduce", (2, 8), (2, 8)),
                            ("scatter", (2, 8), (2, 4)),
                            ("gather", (2, 4), (2, 8)),
                            ("sp_scatter", (8, 3), (4, 3)),
                            ("sp_reduce_scatter", (8, 2), (4, 2)),
                            ("sp_gather", (4, 3), (8, 3))):
        x[name], x[name + "_dy"] = f(own, *shape), f(own, *dy)
    x["lin_x"] = lin_x  # replicated, as a TP layer's input is
    x["lin_dy"], x["gat_dy"] = f(own, 2, 8), f(own, 2, 16)
    x["sp_x"], x["spc_dy"] = f(own, 4, 2, 8), f(own, 8, 2, 8)
    x["ids"] = np.array([[0, 3, 7, 8, 15], [9, -1, 16, 2, 12]], np.int64)
    x["emb_dy"] = f(own, 2, 5, 8)
    logits = f(shared, 2, 3, 16) * 3
    x["logits"] = logits[..., h]
    x["target"] = np.array([[1, 9, -100], [15, 16, 8]], np.int64)
    x["xent_dy"] = f(own, 2, 3)
    x["mrf_x"], x["mrf_w"] = f(own, 2, 5, 16), f(own, 16, 24)
    x["mrf_dy"] = f(own, 2, 5, 24)
    x["mrs_x"], x["mrs_w"] = f(own, 8, 16), f(shared, 16, 12)
    x["agm_x"] = f(own, 4, 16)
    return x


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("tp_world2")
    script = tmp_path / "worker.py"
    script.write_text(WORKER % dict(inputs=inspect.getsource(inputs)))
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


@pytest.fixture
def jax_tp2():
    """JAX's grid at tp = 2 (the flax layers size their shards from it),
    with the Pallas GEMM of family (a) in interpret mode."""
    jax_ps.initialize_model_parallel(tensor_model_parallel_size_=2,
                                     devices=jax.devices()[:WORLD])
    kreg = get_kernel_registry()
    kreg.force_interpret(True)
    try:
        yield Mesh(np.asarray(jax.devices()[:WORLD]), ("tp",))
    finally:
        kreg.force_interpret(False)
        jax_ps.destroy_model_parallel()


def _jax(mesh, fn):
    """``fn(x)`` on each rank's ``inputs`` in shard_map over 'tp'; outputs
    stacked [world, ...]."""
    per_rank = [inputs(r) for r in range(WORLD)]
    stacked = {k: jnp.asarray(np.stack([x[k] for x in per_rank]))
               for k in per_rank[0]}

    def body(xs):
        out = fn({k: v[0] for k, v in xs.items()})
        return jax.tree_util.tree_map(lambda o: o[None], out)

    f = shard_map(body, mesh=mesh, in_specs=(P("tp"),), out_specs=P("tp"))
    return jax.tree_util.tree_map(np.asarray, f(stacked))


def _vjp(fn, args, dy):
    y, pull = jax.vjp(fn, *args)
    return y, pull(dy)


def _close(got, want, keys):
    for r in range(WORLD):
        for k in keys:
            atol = ATOL * max(1.0, float(np.abs(want[k][r]).max()))
            np.testing.assert_allclose(got[r][k], want[k][r], rtol=RTOL,
                                       atol=atol, err_msg=f"rank {r} {k}")


def test_region_ops_match_jax(ranks, jax_tp2):
    ops = {"copy": jax_tp.copy_to_tensor_model_parallel_region,
           "reduce": jax_tp.reduce_from_tensor_model_parallel_region,
           "scatter": jax_tp.scatter_to_tensor_model_parallel_region,
           "gather": jax_tp.gather_from_tensor_model_parallel_region,
           "sp_scatter": jax_tp.scatter_to_sequence_parallel_region,
           "sp_reduce_scatter":
               jax_tp.reduce_scatter_to_sequence_parallel_region}

    def fn(x):
        out = {}
        for name, op in ops.items():
            out[name], (out[f"{name}_d0"],) = _vjp(
                lambda a, op=op: op(a, "tp"), (x[name],), x[f"{name}_dy"])
        for flag in (True, False):
            out[f"sp_gather_{flag}"], (out[f"sp_gather_{flag}_d0"],) = _vjp(
                lambda a, flag=flag: jax_tp.gather_from_sequence_parallel_region(
                    a, flag, "tp"), (x["sp_gather"],), x["sp_gather_dy"])
        return out

    want = _jax(jax_tp2, fn)
    _close(ranks, want, want.keys())


def test_layers_match_jax_and_dense(ranks, jax_tp2):
    col = jax_tp.ColumnParallelLinear(input_size=8, output_size=16,
                                      gather_output=False)
    row = jax_tp.RowParallelLinear(input_size=16, output_size=8,
                                   input_is_parallel=True)
    gat = jax_tp.ColumnParallelLinear(input_size=8, output_size=16,
                                      gather_output=True, bias=False)
    spc = jax_tp.ColumnParallelLinear(input_size=8, output_size=16,
                                      gather_output=False, bias=False,
                                      sequence_parallel_enabled=True)
    emb = jax_tp.VocabParallelEmbedding(num_embeddings=VOCAB,
                                        embedding_dim=EMB)

    def fn(x):
        out = {}

        def colrow(a, wc, bc, wr, br):
            h = col.apply({"params": {"weight": wc, "bias": bc}}, a)
            return row.apply({"params": {"weight": wr, "bias": br}}, h)

        out["colrow"], grads = _vjp(
            colrow, (x["lin_x"], x["wc"], x["bc"], x["wr"], x["br"]),
            x["lin_dy"])
        (out["colrow_d0"], out["colrow_wc"], out["colrow_bc"],
         out["colrow_wr"], out["colrow_br"]) = grads
        out["gat"], (out["gat_d0"], out["gat_wc"]) = _vjp(
            lambda a, w: gat.apply({"params": {"weight": w}}, a),
            (x["lin_x"], x["wc"]), x["gat_dy"])
        out["spc"], (out["spc_d0"], out["spc_wc"]) = _vjp(
            lambda a, w: spc.apply({"params": {"weight": w}}, a),
            (x["sp_x"], x["wc"]), x["spc_dy"])
        out["emb"], (out["emb_table"],) = _vjp(
            lambda t: emb.apply({"params": {"weight": t}}, x["ids"]),
            (x["table"],), x["emb_dy"])
        for ls in (0.0, 0.1):
            out[f"xent_{ls}"], (out[f"xent_{ls}_d0"],) = _vjp(
                lambda lg, ls=ls: jax_tp.vocab_parallel_cross_entropy(
                    lg, x["target"], label_smoothing=ls, axis_name="tp"),
                (x["logits"],), x["xent_dy"])
        return out

    want = _jax(jax_tp2, fn)
    _close(ranks, want, want.keys())
    # Column x Row is the dense product of the full weights
    shared = np.random.RandomState(300)
    wc, bc, wr, br, _, x = (shared.randn(*s).astype(np.float32) for s in (
        (8, 16), (16,), (16, 8), (8,), (16, 8), (2, 8)))
    dense = (x @ wc + bc) @ wr + br
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["colrow"], dense, rtol=1e-5,
                                   atol=1e-5)
    # ids outside the table look up zeros on every rank (JAX at tp > 1)
    assert not ranks[0]["emb"][1, 1:3].any()


def test_fused_family_a_matches_jax(ranks, jax_tp2):
    def fn(x):
        out = {}
        out["mrf"], (out["mrf_dx"], out["mrf_dw"]) = _vjp(
            lambda a, w: jax_fused_cc.matmul_reduce_from(
                jax_tp.copy_to_tensor_model_parallel_region(a, "tp"), w,
                "tp"), (x["mrf_x"], x["mrf_w"]), x["mrf_dy"])
        out["mrs"] = jax_fused_cc.matmul_reduce_scatter(x["mrs_x"],
                                                        x["mrs_w"], "tp")
        out["agm"] = jax_fused_cc.all_gather_matmul(x["agm_x"], x["mrs_w"],
                                                    "tp")
        return out

    want = _jax(jax_tp2, fn)
    _close(ranks, want, want.keys())
    for r in range(WORLD):
        assert ranks[r]["mrs"].shape == (4, 12)
        assert ranks[r]["agm"].shape == (8, 12)


def test_reduce_scatter_refuses_rows_that_do_not_split_as_jax(ranks,
                                                              jax_tp2):
    with pytest.raises(ValueError, match="divisible"):
        _jax(jax_tp2, lambda x: jax_fused_cc.matmul_reduce_scatter(
            x["mrs_x"][:5], x["mrs_w"], "tp"))
    for r in range(WORLD):
        assert ranks[r]["mrs_ragged_refused"]


@pytest.mark.parametrize("family", ["reduce_from", "scatter", "gather"])
def test_fused_forms_hand_the_collectives_the_unfused_elements(ranks,
                                                               family):
    for r in range(WORLD):
        fused = ranks[r][f"count_{family}_fused"]
        unfused = ranks[r][f"count_{family}_unfused"]
        assert fused == unfused > 0, (r, family, fused, unfused)


def test_grid_helpers_at_tp2(ranks):
    # the tp source's copy reaches both ranks
    np.testing.assert_array_equal(ranks[1]["bcast"], inputs(0)["copy"])
    # the model-parallel stream differs by rank, the default one does not
    assert not np.array_equal(ranks[0]["rng_mp"], ranks[1]["rng_mp"])
    np.testing.assert_array_equal(ranks[0]["rng_default"],
                                  ranks[1]["rng_default"])
    # sequence-parallel gradients are summed over tp, the others kept
    total = inputs(0)["copy"][0] + inputs(1)["copy"][0]
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["sp_grad_ln"], total, rtol=1e-6)
        np.testing.assert_array_equal(ranks[r]["sp_grad_w"],
                                      inputs(r)["copy"][1])
