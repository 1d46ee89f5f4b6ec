"""apex_tpu_torch's ZeRO optimizers and OverlappedDataParallel across two
real processes, against JAX over a two-rank 'dp' axis.

The port's launcher starts two gloo ranks over 127.0.0.1::

    python -m apex_tpu_torch.parallel.multiproc --nnodes 2 --node_rank R \\
        --coordinator 127.0.0.1:PORT worker.py OUT

Each rank makes its own gradients from numpy seeds (this file's
``inputs``), takes two steps of

- ``DistributedFusedAdam`` with ``compress`` None (fp32 reduce-scatter
  and gather), True (int8 gradients with error feedback, bf16 gather),
  int4 both ways, and ``overlap=True`` (int8/bf16, three buckets);
- ``DistributedFusedLAMB(compress=True)``;
- ``OverlappedDataParallel(compress="int8")`` (``fold_average``: the
  1/2 in the dequant scales) over three segments of a linear loss,
  ``sum(w_k * a_k)`` with rank-own ``a_k``, whose gradients are the
  ``a_k`` exactly in both packages, so the payload is the same bits;

and writes its new params, optimizer state (its own shards and
residual) and synced gradients under OUT. JAX runs the same code on the
same inputs with the 'dp' axis bound by ``vmap`` over the two ranks'
inputs (its collectives' batching rules), op by op, so nothing reorders
its fp32 operations. World 1 skips ZeRO's collectives; here a wrong rank
slice, a residual kept on the wrong rank, an average not taken or a
gather out of order would show.

Tolerances: the int payloads bit for bit, and with them the residuals
and the overlapped DDP's synced gradients; Adam's params and state bit
for bit as well (its update is elementwise, the same fp32 operations in
the same order). LAMB's norms are sums in another order: its master and
moments within 1e-6 relative plus 1e-7 absolute (as
``tests/test_torch_zero.py``), its bf16-gathered params within 2**-8
relative (one bf16 rounding of masters an ulp apart). Each rank has
120 s.
"""

import inspect
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from apex_tpu.contrib.optimizers import (
    DistributedFusedAdam as JaxAdam,
    DistributedFusedLAMB as JaxLAMB,
)
from apex_tpu.parallel import OverlappedDataParallel as JaxODP
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
SHAPES = {"w": (24, 20), "b": (20,), "e": (37, 13), "s": (5,)}
MESSAGE_SIZE = 500
LR = 1e-2
STEPS = 2
CASES = {  # name -> (optimizer, its keywords)
    "adam_fp32": ("adam", {}),
    "adam_int8": ("adam", dict(compress=True)),
    "adam_int4": ("adam", dict(grad_compress="int4", param_compress="int4")),
    "adam_overlap": ("adam", dict(compress=True, overlap=True,
                                  message_size=MESSAGE_SIZE)),
    "lamb_int8": ("lamb", dict(compress=True)),
}
SEGMENTS = 3

WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.parallel import OverlappedDataParallel
from apex_tpu_torch.parallel.multiproc import initialize_distributed

SHAPES, LR, STEPS, CASES, SEGMENTS = %(consts)r
%(inputs)s
%(flat_state)s
%(linear_segments)s
initialize_distributed(device="cpu")  # the launcher's env
rank = dist.get_rank()
assert dist.get_world_size() == 2, dist.get_world_size()
x = {k: torch.from_numpy(v) for k, v in inputs(rank).items()}
out = {}
classes = {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB}
for name, (kind, kw) in CASES.items():
    opt = classes[kind](lr=LR, weight_decay=0.01, **kw)
    p = {k: x[f"p_{k}"] for k in SHAPES}
    st = opt.init(p)
    for step in range(STEPS):
        p, st = opt.step({k: x[f"g{step}_{k}"] for k in SHAPES}, st, p)
    out.update({f"{name}/p/{k}": v for k, v in p.items()})
    out.update({f"{name}/s/{k}": torch.as_tensor(v)
                for k, v in flat_state(st).items()})
odp = OverlappedDataParallel(compress="int8", message_size=400)
seg_p = [{"w": x[f"p_{k}"]} for k in ("w", "e", "s")]
res = None
for step in range(STEPS):
    segs = linear_segments([x[f"a{step}_{k}"] for k in ("w", "e", "s")])
    loss, synced, res = odp.value_and_sync(segs, seg_p, x["x0"], residual=res)
    out[f"odp{step}/loss"] = loss
    out.update({f"odp{step}/g{k}": g["w"] for k, g in enumerate(synced)})
    out.update({f"odp{step}/r{k}.{b}": r for k, seg in enumerate(res)
                for b, r in enumerate(seg)})
np.savez(sys.argv[1] + f"/rank{rank}.npz",
         **{k: v.detach().numpy() for k, v in out.items()})
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def inputs(rank):
    """Rank ``rank``'s inputs: the params (seed 0, every rank), its
    gradients and its linear loss's data (seed 100 + rank)."""
    p_rng = np.random.RandomState(0)
    x = {f"p_{k}": p_rng.randn(*s).astype(np.float32)
         for k, s in SHAPES.items()}
    rng = np.random.RandomState(100 + rank)
    for step in range(STEPS):
        for k, s in SHAPES.items():
            x[f"g{step}_{k}"] = (rng.randn(*s) * 10.0 ** (rank - 1)).astype(
                np.float32)
            x[f"a{step}_{k}"] = rng.randn(*s).astype(np.float32)
    x["x0"] = np.zeros((), np.float32)
    return x


def flat_state(state):
    """{key path: value} of an optimizer state, buckets unrolled."""
    if "buckets" not in state:
        return dict(state)
    out = {"step": state["step"]}
    for k, seg in enumerate(state["buckets"]):
        for b, bstate in enumerate(seg):
            out.update({f"{k}.{b}.{n}": v for n, v in bstate.items()})
    return out


def linear_segments(data):
    """Segment k adds ``sum(w_k * data[k])`` to the carry; the last one's
    carry is the loss. The gradient of w_k is data[k] exactly."""
    return [lambda p, h, a=a: h + (p["w"] * a).sum() for a in data]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER % dict(
        consts=(SHAPES, LR, STEPS, CASES, SEGMENTS),
        inputs=inspect.getsource(inputs),
        flat_state=inspect.getsource(flat_state),
        linear_segments=inspect.getsource(linear_segments)))
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


def _jax_ranks(fn, stacked):
    """``fn`` on each rank's inputs with the 'dp' axis bound by vmap:
    outputs stacked [world, ...], as numpy."""
    out = jax.vmap(fn, axis_name="dp")(
        jax.tree_util.tree_map(jnp.asarray, stacked))
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_results(stacked):
    want = {}
    classes = {"adam": JaxAdam, "lamb": JaxLAMB}
    for name, (kind, kw) in CASES.items():
        opt = classes[kind](lr=LR, weight_decay=0.01, **kw)

        def run(x, opt=opt):
            p = {k: x[f"p_{k}"] for k in SHAPES}
            st = opt.init(p)
            for step in range(STEPS):
                p, st = opt.step({k: x[f"g{step}_{k}"] for k in SHAPES},
                                 st, p)
            return p, flat_state(st)

        p, st = _jax_ranks(run, stacked)
        want.update({f"{name}/p/{k}": v for k, v in p.items()})
        want.update({f"{name}/s/{k}": v for k, v in st.items()})
    odp = JaxODP(axis_name="dp", compress="int8", message_size=400)

    def run_odp(x):
        seg_p = [{"w": x[f"p_{k}"]} for k in ("w", "e", "s")]
        out, res = {}, None
        for step in range(STEPS):
            segs = linear_segments([x[f"a{step}_{k}"]
                                    for k in ("w", "e", "s")])
            loss, synced, res = odp.value_and_sync(segs, seg_p, x["x0"],
                                                   residual=res)
            out[f"odp{step}/loss"] = loss
            out.update({f"odp{step}/g{k}": g["w"]
                        for k, g in enumerate(synced)})
            out.update({f"odp{step}/r{k}.{b}": r for k, seg in enumerate(res)
                        for b, r in enumerate(seg)})
        return out

    want.update(_jax_ranks(run_odp, stacked))
    return want


def test_two_gloo_ranks_match_jax(tmp_path):
    got = _run_ranks(tmp_path)
    per_rank = [inputs(r) for r in range(WORLD)]
    stacked = {k: np.stack([x[k] for x in per_rank]) for k in per_rank[0]}
    want = _jax_results(stacked)
    for r in range(WORLD):
        assert set(got[r]) == set(want), sorted(set(got[r]) ^ set(want))
        for k, w in want.items():
            g, w = got[r][k], w[r]
            assert g.shape == w.shape, (r, k, g.shape, w.shape)
            what = f"rank {r} {k}"
            if k.startswith("lamb") and "grad_residual" not in k:
                if "/p/" in k:
                    np.testing.assert_allclose(g, w, rtol=2 ** -8, atol=0,
                                               err_msg=what)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                               err_msg=what)
            elif k.endswith("/loss"):
                np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=what)
            else:
                np.testing.assert_array_equal(g, w, err_msg=what)
    # the ranks hold their own shards and the same gathered params
    for name in CASES:
        key = (f"{name}/s/0.0.master_shard" if "overlap" in name
               else f"{name}/s/master_shard")
        assert not np.array_equal(got[0][key], got[1][key]), name
        for k in SHAPES:
            np.testing.assert_array_equal(got[0][f"{name}/p/{k}"],
                                          got[1][f"{name}/p/{k}"])
