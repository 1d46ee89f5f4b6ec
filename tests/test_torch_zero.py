"""apex_tpu_torch.contrib.optimizers (DistributedFusedAdam,
DistributedFusedLAMB) against apex_tpu.contrib.optimizers on the CPU, at
world size 1 with no process group (both packages then skip their
collectives and update the whole flat vector).

Inputs are a four-leaf dict from numpy seeds, one leaf of a ragged size
(37 x 13), so the flat vector's pad tail and, with int8 gradients, the
256-lane block alignment are exercised; ``message_size`` 500 cuts it
into three buckets for ``overlap=True``. The JAX optimizers' steps run op
by op with their inputs traced (``vmap`` over one copy), so the step
counter is traced as in JAX's jitted training step; their update is the
jnp oracle of the Adam/LAMB kernels (the gates are off on the CPU), the
port's the kernels' plain versions.

- Adam and LAMB, monolithic and ``overlap=True``, ``compress`` None and
  True, over four steps: plain, ``found_inf=1`` (params, state and
  ``step`` unchanged), ``scale=4`` on gradients times 4, plain; LAMB
  with ``max_grad_norm`` 0 and 1 and ``use_nvlamb`` (weight decay 0).
- The state keys, ``zero_state_bytes`` / ``state_bytes`` reports and the
  refusals (``numerics=``, ``registry=``, the 3-D state).
- Elastic round trips 8 -> 4 -> 1 -> 8 of the flat, bucketed and 2-D
  (mesh2d's GPT-2 partition dims, (dp, tp) = (2, 4) -> (2, 2) -> (1, 1)
  -> (2, 4)) state, against JAX's host math at every hop.
- A state written by JAX's ``state_dict_full`` loaded into the port and
  stepped on.
- JAX's DistributedFusedLAMB against its FusedLAMB at step 1: the
  tolerance ``chip_smoke.py``'s ``zero_bert`` holds the port's pair to.

Tolerances: Adam bit for bit (the same fp32 operations in the same
order; the bias corrections are the fp32 values of the traced power).
LAMB's norms are sums in another order (``torch._foreach_norm``
against XLA's reduce), so its params and moments are held within 1e-6
relative plus 1e-7 absolute, as ``tests/test_torch_optim.py`` holds
FusedLAMB. The elastic dicts and states are numpy copies: bit for bit.
The sharded and the unsharded LAMB run the same elementwise math with
the gradient norm and each tensor's ||p|| and ||update|| summed in
another order, so their step-1 parameters may differ by one fp32 ulp
(the rounding of p - lr * ratio * u) plus ZERO_VS_FUSED_LAMB_RTOL (1e-5)
of each element's update (``excess_over_ulp``): a pairwise fp32 sum of
n terms is within log2(n) * 2^-24 relative (1.7e-6 at BERT-large's
3.7e8 parameters), the update moves with two such norms through the
trust ratio and with the clip factor barely (h / (|h| + eps)). Measured
here: one ulp at most, nothing past it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.optimizers import (
    DistributedFusedAdam as JaxAdam,
    DistributedFusedLAMB as JaxLAMB,
)
from apex_tpu.contrib.optimizers import distributed_fused_adam as jax_dfa
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.parallel import mesh2d as jax_mesh2d
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.contrib.optimizers import distributed_fused_adam as dfa
from apex_tpu_torch.parallel import mesh2d
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"w": (24, 20), "b": (20,), "e": (37, 13), "s": (5,)}
MESSAGE_SIZE = 500  # buckets [b], [e, s], [w] in sorted-key order
LR = 1e-2
LAMB_RTOL, LAMB_ATOL = 1e-6, 1e-7
ZERO_VS_FUSED_LAMB_RTOL = 1e-5


def _np_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat_state(state):
    """{key path: numpy} of an optimizer state, buckets unrolled."""
    out = {"step": _host(state["step"])}
    if "buckets" in state:
        for k, seg in enumerate(state["buckets"]):
            for bi, b in enumerate(seg):
                out.update({f"{k}.{bi}.{n}": _host(v) for n, v in b.items()})
    else:
        out.update({n: _host(v) for n, v in state.items() if n != "step"})
    return out


def _same(got, want, exact, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=LAMB_RTOL, atol=LAMB_ATOL,
                                       err_msg=f"{what} {k}")


def _jax_step(jopt):
    """``jopt.step(g, s, p, found_inf, scale)`` op by op with its inputs
    traced (vmap over one copy): as in JAX's jitted step, ``beta ** step``
    is the traced fp32 power (eagerly, a concrete int32 takes integer_pow,
    a rounding away at step 3), and no fusion reorders the update."""
    def step(g, s, p, found_inf=0.0, scale=1.0):
        one = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None],
                                     (g, s, p, jnp.float32(found_inf),
                                      jnp.float32(scale)))
        out = jax.vmap(lambda g, s, p, f, c: jopt.step(
            g, s, p, found_inf=f, scale=c))(*one)
        return jax.tree_util.tree_map(lambda x: x[0], out)

    return step


# the four steps: (grad seed, gradient scale and scale argument, found_inf)
STEPS = [(10, 1.0, None), (11, 1.0, 1.0), (12, 4.0, None), (13, 1.0, None)]


def _run_both(make, exact):
    """``make(module)`` builds each package's optimizer; both step through
    STEPS from the same params and are compared after each."""
    p0 = _np_tree(0)
    jopt, topt = make(JaxAdam, JaxLAMB), make(DistributedFusedAdam,
                                             DistributedFusedLAMB)
    jp, tp = _jax(p0), _torch(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    _same(_flat_state(ts), _flat_state(js), True, "init")
    jstep = _jax_step(jopt)
    for k, (seed, gscale, found_inf) in enumerate(STEPS):
        g = _np_tree(seed, gscale)
        before = {n: v.copy() for n, v in _flat_state(ts).items()}
        jp, js = jstep(_jax(g), js, jp, found_inf or 0.0, gscale)
        tp, ts = topt.step(_torch(g), ts, tp, found_inf=(
            None if found_inf is None else torch.tensor(found_inf)),
            scale=gscale)
        what = f"step {k + 1}"
        _same({n: v.numpy() for n, v in tp.items()},
              {n: np.asarray(v) for n, v in jp.items()}, exact, what)
        _same(_flat_state(ts), _flat_state(js), exact, what)
        if found_inf:  # a skipped step changes nothing
            _same(_flat_state(ts), before, True, what)
    assert int(ts["step"]) == len(STEPS) - 1
    return topt, tp, ts


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("compress", [False, True])
def test_adam_matches_jax_bit_for_bit(overlap, compress):
    def make(adam, lamb):
        return adam(lr=LR, weight_decay=0.01, compress=compress,
                    overlap=overlap, message_size=MESSAGE_SIZE)

    opt, params, state = _run_both(make, exact=True)
    if overlap:
        assert [len(s) for s in state["buckets"]] == [3]
    # the new params never alias the master shard (updated in place)
    masters = ([b["master_shard"] for b in state["buckets"][0]] if overlap
               else [state["master_shard"]])
    for p in params.values():
        assert all(p.untyped_storage().data_ptr()
                   != m.untyped_storage().data_ptr() for m in masters)


@pytest.mark.parametrize("overlap,compress,max_grad_norm,nvlamb", [
    (False, False, 1.0, False), (False, True, 0.0, False),
    (False, False, 1.0, True), (True, False, 1.0, False),
    (True, True, 0.0, True)])
def test_lamb_matches_jax(overlap, compress, max_grad_norm, nvlamb):
    def make(adam, lamb):
        return lamb(lr=LR, weight_decay=0.0 if nvlamb else 0.01,
                    use_nvlamb=nvlamb, max_grad_norm=max_grad_norm,
                    compress=compress, overlap=overlap,
                    message_size=MESSAGE_SIZE)

    _run_both(make, exact=False)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("compress", [False, True])
def test_state_bytes_match_jax(world, compress):
    jp, tp = _jax(_np_tree(0)), _torch(_np_tree(0))
    for jcls, tcls in ((JaxAdam, DistributedFusedAdam),
                       (JaxLAMB, DistributedFusedLAMB)):
        want = jcls(compress=compress).state_bytes(jp, world=world,
                                                   record=False)
        assert tcls(compress=compress).state_bytes(tp, world=world) == want
    want = jax_dfa.zero_state_bytes(jp, world=world, grad_compress="int4",
                                    record=False)
    assert dfa.zero_state_bytes(tp, world=world,
                                grad_compress="int4") == want


def test_refusals_name_their_items():
    # the telemetry knobs run (numerics=, the registry of
    # zero_state_bytes), held to JAX's: the grads statistics appended to
    # the step's return (counts and absmax exact), the same gauges and
    # event from the byte report
    from apex_tpu.telemetry import MetricsRegistry as JaxRegistry
    from apex_tpu_torch.telemetry import MetricsRegistry, numerics

    for jcls, tcls in ((JaxAdam, DistributedFusedAdam),
                       (JaxLAMB, DistributedFusedLAMB)):
        for overlap in (False, True):
            kw = dict(numerics=1, overlap=overlap, message_size=MESSAGE_SIZE)
            jopt, topt = jcls(**kw), tcls(**kw)
            p0, g = _np_tree(0), _np_tree(10)
            g["b"][:4] = 0.0
            out_j = _jax_step(jopt)(_jax(g), jopt.init(_jax(p0)), _jax(p0))
            tp = _torch(p0)
            out_t = topt.step(_torch(g), topt.init(tp), tp)
            assert len(out_t) == len(out_j) == 3
            got = numerics.stats_to_floats(out_t[2])
            assert sorted(got) == sorted(out_j[2]) == sorted(
                f"grads/{k}" for k in SHAPES)
            for key, row in got.items():
                for field, v in row.items():
                    w = float(getattr(out_j[2][key], field))
                    if field in ("l2", "rms"):
                        assert v == pytest.approx(w, rel=1e-6), (key, field)
                    else:
                        assert v == w, (key, field)
    events = []
    for reg, mod, tree in ((JaxRegistry(enabled=True), jax_dfa,
                            _jax(_np_tree(0))),
                           (MetricsRegistry(enabled=True), dfa,
                            _torch(_np_tree(0)))):
        got = []
        reg.add_event_tap(got.append)
        mod.zero_state_bytes(tree, world=2, grad_compress="int8",
                             registry=reg)
        events.append(([{k: v for k, v in e.items() if k not in ("t", "ts")}
                        for e in got], reg.snapshot()["gauges"]))
    assert events[1] == events[0] and events[0][1]
    opt = DistributedFusedAdam()
    with pytest.raises(NotImplementedError, match="item 6"):
        opt.state_dict_full({}, {}, world=(2, 2, 2), partition_dims={})
    with pytest.raises(NotImplementedError, match="item 6"):
        opt.load_state_dict_resharded({}, {}, world=(2, 2, 2),
                                      partition_dims={})
    with pytest.raises(NotImplementedError, match="item 6"):
        dfa.reshard_zero_state_3d({}, [], {}, dp_world=1, tp_world=1,
                                  pp_world=2)
    with pytest.raises(ValueError, match="no global-norm"):
        DistributedFusedAdam(overlap=True).bucket_update_gather(
            None, {}, None, [], step=1, noop=None, clip=1.0)


# ------------------------------------------------------------ elastic

def _full_dict(n, seed=3):
    rng = np.random.RandomState(seed)
    return {"format": 1, "n_elements": n, "step": np.int32(9),
            "master": rng.randn(n).astype(np.float32),
            "exp_avg": rng.randn(n).astype(np.float32),
            "exp_avg_sq": np.abs(rng.randn(n)).astype(np.float32),
            "grad_residual": (rng.randn(n) * 1e-3).astype(np.float32)}


def _same_dict(got, want, what):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        if isinstance(w, (np.ndarray, np.generic, jax.Array)):
            g = _host(got[k])
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            assert got[k] == w, (what, k)


def _states_equal(got, want, what):
    if isinstance(want, list):
        assert len(got) == len(want)
        for t, (g, w) in enumerate(zip(got, want)):
            _states_equal(g, w, f"{what} model rank {t}")
        return
    _same(_flat_state(got), _flat_state(want), True, what)


@pytest.mark.parametrize("layout", ["flat", "bucketed", "2d"])
def test_elastic_round_trip_8_4_1_8_matches_jax(layout):
    if layout == "2d":
        jp = jax_mesh2d.gpt2_init(hidden=16, layers=2, heads=4, vocab=24,
                                  max_seq=8)
        tp = mesh2d.gpt2_init(hidden=16, layers=2, heads=4, vocab=24,
                              max_seq=8, device="cpu")
        kw_j = dict(partition_dims=jax_mesh2d.gpt2_partition_dims(jp))
        kw_t = dict(partition_dims=mesh2d.gpt2_partition_dims(tp))
        worlds = [(2, 4), (2, 2), (1, 1), (2, 4)]
        full = dict(_full_dict(dfa._flat_size(tp)), format=2)
    else:
        jp, tp = _jax(_np_tree(0)), _torch(_np_tree(0))
        kw_j = kw_t = {}
        worlds = [8, 4, 1, 8]
        full = _full_dict(dfa._flat_size(tp))
    mk = dict(compress=True, overlap=layout != "flat",
              message_size=MESSAGE_SIZE)
    jopt, topt = JaxAdam(**mk), DistributedFusedAdam(**mk)
    first = None
    for world in worlds:
        js = jopt.load_state_dict_resharded(full, jp, world=world, **kw_j)
        ts = topt.load_state_dict_resharded(full, tp, world=world, **kw_t)
        _states_equal(ts, js, f"{layout} resharded to {world}")
        full = jopt.state_dict_full(js, jp, world=world, **kw_j)
        _same_dict(topt.state_dict_full(ts, tp, world=world, **kw_t), full,
                   f"{layout} consolidated at {world}")
        first = first or full
    for k in ("master", "exp_avg", "exp_avg_sq", "grad_residual"):
        np.testing.assert_array_equal(full[k], first[k])


def test_jax_written_state_loads_and_steps():
    """JAX steps twice and writes its state; the port loads it and takes
    step 3 to JAX's own step 3, bit for bit."""
    p0, gs = _np_tree(0), [_np_tree(20 + k) for k in range(3)]
    jopt = JaxAdam(lr=LR, compress=True)
    jstep = _jax_step(jopt)
    jp = _jax(p0)
    js = jopt.init(jp)
    for g in gs[:2]:
        jp, js = jstep(_jax(g), js, jp)
    full = jopt.state_dict_full(js, jp, world=1)
    topt = DistributedFusedAdam(lr=LR, compress=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ts = topt.load_state_dict_resharded(full, tp, world=1)
    assert ts["step"].device.type == "cpu" and int(ts["step"]) == 2
    # the host-global residual is a (world, padded) stack: rank 0's row
    ts["grad_residual"] = ts["grad_residual"][0]
    jp, js = jstep(_jax(gs[2]), js, jp)
    tp, ts = topt.step(_torch(gs[2]), ts, tp)
    _same({k: v.numpy() for k, v in tp.items()},
          {k: np.asarray(v) for k, v in jp.items()}, True, "step 3")
    _same(_flat_state(ts), _flat_state(js), True, "step 3 state")


def excess_over_ulp(got, want, before):
    """max over elements of (|got - want| - one fp32 ulp of want) /
    |want - before|: how far past its last-place rounding a new parameter
    is, in units of its update."""
    got, want = np.asarray(got, np.float64), np.asarray(want)
    ulp = np.spacing(np.abs(want)).astype(np.float64)
    upd = np.abs(want.astype(np.float64) - np.asarray(before))
    return float(np.max(np.maximum(np.abs(got - want) - ulp, 0)
                        / np.maximum(upd, 1e-30)))


def test_sharded_lamb_vs_fused_lamb_tolerance_in_jax():
    """JAX's sharded LAMB against its unsharded FusedLAMB at step 1 (BERT's
    settings): the distance zero_bert allows the port's pair on the card."""
    params, grads = _jax(_np_tree(0)), _jax(_np_tree(30, 0.1))
    kw = dict(lr=1e-3, weight_decay=0.01, eps=1e-6, max_grad_norm=1.0)
    zp, _ = JaxLAMB(**kw).step(grads, JaxLAMB(**kw).init(params), params)
    fopt = JaxFusedLAMB(**kw)
    fp, _ = fopt.step(grads, fopt.init(params), params)
    for k in SHAPES:
        assert not np.array_equal(np.asarray(fp[k]), np.asarray(params[k]))
        assert excess_over_ulp(zp[k], fp[k], params[k]) <= \
            ZERO_VS_FUSED_LAMB_RTOL, k


def test_plain_sqrt_is_correctly_rounded_as_jax():
    """The optimizer kernels' plain versions take fp32 square roots through
    float64 on the CPU: torch's CPU sqrt gives 0x1.2de836p-4 for this
    v / bc2 (from the two-rank int8 ZeRO step of
    tests/test_torch_zero_world2.py; torch 2.x), XLA's and CUDA's
    0x1.2de838p-4, the correctly rounded root."""
    from apex_tpu_torch.kernels import optim

    x = np.float32(float.fromhex("0x1.640be4p-8"))
    want = np.asarray(jnp.sqrt(jnp.float32(x)))
    assert float(want) == float.fromhex("0x1.2de838p-4")
    got = optim._sqrt(torch.tensor([x]))
    np.testing.assert_array_equal(got.numpy()[0], want)
