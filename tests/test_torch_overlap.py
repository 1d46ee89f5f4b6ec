"""apex_tpu_torch.parallel.overlap (plan_overlap, OverlappedDataParallel,
overlapped_zero_step) against apex_tpu.parallel.overlap on the CPU, on a
one-rank gloo group (a FileStore under tmp_path).

The model is ``bench.py bench_ddp_overlapped``'s tanh MLP regressor,
narrowed: 3 layers of width 40 (a 1600-element weight is 6.25 blocks of
256: ragged), one segment a layer, batch 4, RandomState weights and
data; ``message_size`` 1000 puts each bias and each weight in a bucket
of its own (6 buckets). The JAX side runs ``value_and_sync`` op by op
with the 'dp' axis bound by ``vmap`` over one copy, as
``tests/test_torch_ddp.py`` runs its DDP.

- ``value_and_sync`` in every compress mode (None, bf16, int8, int4),
  ``fold_average`` on and off, two steps with the residual carried; the
  plan, ``init_residual`` and ``residual_to_tree``; the int4 step's
  int8 payload, as JAX's (ROADMAP queue C, reproduced).
- ``overlapped_zero_step`` with ``DistributedFusedAdam(overlap=True)``:
  bit-identical to the monolithic ``step`` on the whole model's
  gradients (JAX's ``test_adam_fp32_overlap_bit_identical``), and held
  to JAX's; with ``DistributedFusedLAMB``: the monolithic step
  within summation order.
- The refusals: ``guard_flag``, ``numerics``, the 3-D reshard.

Tolerances: the two packages' gradients are fp32 autodiff of the same
model, sums in another order: the loss within 1e-6 relative, fp32
gradients within 1e-5 relative plus 1e-5 of the largest |g| (as the DDP
module-wrapping test); bf16 payloads one bf16 rounding more (2**-8). In
the int modes a gradient within its last fp32 places of a rounding
boundary of its block's grid may take the other code: each synced
gradient and residual is held within one block scale (the largest
absmax / 127 of its bucket) plus the fp32 part, at most 1 % of the
entries past the fp32 part alone, and synced + new residual (the
payload, which error feedback keeps whole at world 1) within the fp32
part. The Adam overlapped step against JAX's: the two steps' update (params
after minus before) within ADAM_UPDATE_RTOL (1e-4) relative Frobenius:
Adam's update is lr * g / (|g| + eps) per element, so an entry whose |g|
lies near the gradients' fp32 disagreement may move by up to 2 lr, the
rest by the gradients' 1e-5. The LAMB one against the monolithic step: 1e-6
relative plus 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu.contrib.optimizers import DistributedFusedAdam as JaxAdam
from apex_tpu.parallel import OverlappedDataParallel as JaxODP
from apex_tpu.parallel import overlapped_zero_step as jax_zero_step
from apex_tpu.parallel import plan_overlap as jax_plan_overlap
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)
from apex_tpu_torch.contrib.optimizers import distributed_fused_adam as dfa
from apex_tpu_torch.parallel import (
    OverlappedDataParallel,
    overlapped_zero_step,
    plan_overlap,
)
from torch_threads import one_torch_thread  # noqa: F401

DEPTH, HIDDEN, BATCH = 3, 40, 4
MESSAGE_SIZE = 1000
RTOL, GRAD_FLOOR = 1e-5, 1e-5
ADAM_UPDATE_RTOL = 1e-4


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _np_params(seed=0):
    rng = np.random.RandomState(seed)
    return [{f"w{i}": (rng.randn(HIDDEN, HIDDEN) / np.sqrt(HIDDEN)).astype(
                np.float32),
             f"b{i}": (0.01 * rng.randn(HIDDEN)).astype(np.float32)}
            for i in range(DEPTH)]


def _data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, HIDDEN).astype(np.float32),
            rng.randn(BATCH, HIDDEN).astype(np.float32))


def _jax_segments(yb):
    segs = [lambda p, h, i=i: jnp.tanh(h @ p[f"w{i}"] + p[f"b{i}"])
            for i in range(DEPTH - 1)]

    def last(p, h, i=DEPTH - 1):
        return jnp.mean((jnp.tanh(h @ p[f"w{i}"] + p[f"b{i}"]) - yb) ** 2)

    return segs + [last]


def _torch_segments(yb):
    segs = [lambda p, h, i=i: torch.tanh(h @ p[f"w{i}"] + p[f"b{i}"])
            for i in range(DEPTH - 1)]

    def last(p, h, i=DEPTH - 1):
        return torch.mean((torch.tanh(h @ p[f"w{i}"] + p[f"b{i}"]) - yb) ** 2)

    return segs + [last]


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _jax_value_and_sync(odp, sp, x, y, residual):
    """JAX's value_and_sync with 'dp' bound by vmap over one copy."""
    def body(sp, x, y, residual):
        if residual is None:
            return odp.value_and_sync(_jax_segments(y), sp, x)
        return odp.value_and_sync(_jax_segments(y), sp, x, residual=residual)

    one = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None],
                                 (sp, x, y, residual))
    out = jax.vmap(body, axis_name="dp")(*one)
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[0], out)


def _flat(tree):
    return np.concatenate([np.asarray(a).reshape(-1)
                           for a in jax.tree_util.tree_leaves(tree)])


def test_plan_and_init_residual_match_jax():
    sp = _np_params()
    for ms in (MESSAGE_SIZE, 100, 10000000):
        want = jax_plan_overlap(jax.tree_util.tree_map(jnp.asarray, sp),
                                message_size=ms)
        got = plan_overlap(_torch_tree(sp), message_size=ms)
        assert [[tuple(b) for b in s] for s in got] == \
            [[tuple(b) for b in s] for s in want]
    odp = OverlappedDataParallel(message_size=MESSAGE_SIZE, compress="int8")
    res = odp.init_residual(_torch_tree(sp))
    want = JaxODP(message_size=MESSAGE_SIZE,
                  compress="int8").init_residual(sp)
    assert [[tuple(r.shape) for r in s] for s in res] == \
        [[r.shape for r in s] for s in want]
    assert not any(r.any() for s in res for r in s)


@pytest.mark.parametrize("compress,fold", [
    (None, True), ("bf16", True), ("int8", True), ("int8", False),
    ("int4", True)])
def test_value_and_sync_matches_jax(world1, compress, fold):
    sp, (x, y) = _np_params(), _data()
    kw = dict(message_size=MESSAGE_SIZE, compress=compress,
              fold_average=fold)
    jodp, odp = JaxODP(axis_name="dp", **kw), OverlappedDataParallel(**kw)
    is_int = compress in ("int8", "int4")
    plan = odp.plan(_torch_tree(sp))
    jres = tres = None
    for step in range(2):
        want = _jax_value_and_sync(jodp, sp, x, y, jres)
        got = odp.value_and_sync(_torch_segments(torch.from_numpy(y)),
                                 _torch_tree(sp), torch.from_numpy(x),
                                 residual=tres)
        np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
        assert len(got) == (3 if is_int else 2)
        for k, seg in enumerate(plan):
            names = sorted(want[1][k])
            for bi, b in enumerate(seg):
                sy_t = np.concatenate([got[1][k][names[i]].numpy().reshape(-1)
                                       for i in b.leaf_idx])
                sy_j = np.concatenate([want[1][k][names[i]].reshape(-1)
                                       for i in b.leaf_idx])
                floor = GRAD_FLOOR * np.abs(sy_j).max()
                what = f"step {step + 1} bucket {k}.{bi}"
                if not is_int:
                    np.testing.assert_allclose(
                        sy_t, sy_j, rtol=2 ** -8 if compress else RTOL,
                        atol=floor, err_msg=what)
                    continue
                r_t = got[2][k][bi].numpy().reshape(-1)
                r_j = want[2][k][bi].reshape(-1)
                assert not r_t[b.n:].any(), what  # the pad tail stays 0
                r_t, r_j = r_t[:b.n], r_j[:b.n]
                # error feedback keeps the payload whole at world 1
                np.testing.assert_allclose(sy_t + r_t, sy_j + r_j, rtol=RTOL,
                                           atol=floor, err_msg=what)
                # a code flip moves a value by one scale of its block, at
                # most the bucket's largest |synced| / 127
                quantum = 1.01 * np.abs(sy_j).max() / 127
                for a, w in ((sy_t, sy_j), (r_t, r_j)):
                    d = np.abs(a - w) - RTOL * np.abs(w) - floor
                    assert np.all(d <= quantum), (what, d.max(), quantum)
                    assert np.mean(d > 0) <= 0.01, (what, np.mean(d > 0))
        if is_int:
            tres, jres = got[2], want[2]


def test_residual_to_tree_matches_jax(world1):
    sp = _np_params()
    jodp = JaxODP(axis_name="dp", message_size=MESSAGE_SIZE,
                  compress="int8")
    rng = np.random.RandomState(5)
    res = jax.tree_util.tree_map(
        lambda r: jnp.asarray(rng.randn(*r.shape).astype(np.float32)),
        jodp.init_residual(sp))
    want = jodp.residual_to_tree(sp, res)
    odp = OverlappedDataParallel(message_size=MESSAGE_SIZE, compress="int8")
    got = odp.residual_to_tree(_torch_tree(sp), _torch_tree(res))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_int4_overlapped_step_sends_int8_as_jax_does(world1):
    """JAX's overlapped step sends every residual mode through the int8
    block collective (apex_tpu/parallel/overlap.py:217-231): its int4
    step equals its int8 step, and so does the port's."""
    sp, (x, y) = _np_params(), _data()
    outs = {}
    for mode in ("int8", "int4"):
        kw = dict(message_size=MESSAGE_SIZE, compress=mode)
        outs[mode] = (
            _jax_value_and_sync(JaxODP(axis_name="dp", **kw), sp, x, y, None),
            OverlappedDataParallel(**kw).value_and_sync(
                _torch_segments(torch.from_numpy(y)), _torch_tree(sp),
                torch.from_numpy(x)))
    for j8, j4 in [(outs["int8"][0], outs["int4"][0])]:
        np.testing.assert_array_equal(_flat(j8[1]), _flat(j4[1]))
        np.testing.assert_array_equal(_flat(j8[2]), _flat(j4[2]))
    t8, t4 = outs["int8"][1], outs["int4"][1]
    for a, b in zip(t8[1], t4[1]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(t8[2], t4[2]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


# ------------------------------------------------------------------ ZeRO

def _monolithic(opt, sp, x, y, steps):
    """``opt.step`` on the whole model's gradients (one backward)."""
    sp = _torch_tree(sp)
    state = opt.init(sp)
    for _ in range(steps):
        leaves = [p.requires_grad_() for s in sp for p in s.values()]
        h = torch.from_numpy(x)
        for i in range(DEPTH):
            p = sp[i]
            h = torch.tanh(h @ p[f"w{i}"] + p[f"b{i}"])
        loss = torch.mean((h - torch.from_numpy(y)) ** 2)
        g = torch.autograd.grad(loss, leaves)
        it = iter(g)
        grads = [{k: next(it) for k in s} for s in sp]
        sp = [{k: v.detach() for k, v in s.items()} for s in sp]
        sp, state = opt.step(grads, state, sp)
    return loss.item(), sp


def _overlapped(opt, sp, x, y, steps):
    sp = _torch_tree(sp)
    state = opt.init(sp)
    for _ in range(steps):
        loss, sp, state = overlapped_zero_step(
            _torch_segments(torch.from_numpy(y)), sp, opt, state,
            torch.from_numpy(x))
    return loss.item(), sp, state


@pytest.mark.parametrize("compress", [False, True])
def test_overlapped_zero_step_adam_bit_identical_to_monolithic_and_near_jax(compress):
    sp, (x, y) = _np_params(), _data()
    kw = dict(lr=1e-2, compress=compress, message_size=MESSAGE_SIZE)
    loss_m, p_m = _monolithic(DistributedFusedAdam(**kw), sp, x, y, 2)
    opt = DistributedFusedAdam(overlap=True, **kw)
    loss_d, p_d, state = _overlapped(opt, sp, x, y, 2)
    assert [len(s) for s in state["buckets"]] == [2, 2, 2]
    assert int(state["step"]) == 2
    assert loss_d == loss_m
    for a, b in zip(p_d, p_m):
        assert all(torch.equal(a[k], b[k]) for k in a)
    # JAX's overlapped_zero_step, jitted as it trains (no axis: world 1)
    jopt = JaxAdam(overlap=True, **kw)
    jsp = jax.tree_util.tree_map(jnp.asarray, sp)
    js = jopt.init(jsp)

    @jax.jit
    def drv(sp, state):
        return jax_zero_step(_jax_segments(jnp.asarray(y)), sp, jopt, state,
                             jnp.asarray(x))

    for _ in range(2):
        jloss, jsp, js = drv(jsp, js)
    np.testing.assert_allclose(loss_d, float(jloss), rtol=1e-6)
    before, got, want = _flat(sp), _flat(
        [{k: v.numpy() for k, v in s.items()} for s in p_d]), _flat(jsp)
    err = np.linalg.norm(got - want) / np.linalg.norm(want - before)
    assert err <= ADAM_UPDATE_RTOL, err


def test_overlapped_zero_step_lamb_within_summation_order(world1):
    sp, (x, y) = _np_params(), _data()
    kw = dict(lr=1e-2, message_size=MESSAGE_SIZE)
    _, p_m = _monolithic(DistributedFusedLAMB(**kw), sp, x, y, 2)
    _, p_d, _ = _overlapped(DistributedFusedLAMB(overlap=True, **kw), sp, x, y, 2)
    for a, b in zip(p_d, p_m):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_refusals_and_contract(world1):
    # guard_flag= and numerics= (resilience, telemetry) run: the local
    # non-finite flag and the grads/synced statistics, held to JAX's
    # (flag and counts exact, norms within RTOL), on finite data and on
    # data with a NaN (every gradient poisoned)
    from apex_tpu_torch.telemetry import numerics

    sp, (x, y) = _np_params(), _data()
    kw = dict(message_size=MESSAGE_SIZE, guard_flag=True, numerics=1)
    for poison in (False, True):
        xp = x.copy()
        if poison:
            xp[0, 0] = np.nan
        want = _jax_value_and_sync(JaxODP(axis_name="dp", **kw), sp, xp, y,
                                   None)
        got = OverlappedDataParallel(**kw).value_and_sync(
            _torch_segments(torch.from_numpy(y)), _torch_tree(sp),
            torch.from_numpy(xp))
        assert len(got) == len(want) == 4
        assert float(got[2]) == float(want[2]) == float(poison)
        stats = numerics.stats_to_floats(got[3])
        assert sorted(stats) == sorted(want[3])
        for key, row in stats.items():
            for field, v in row.items():
                w = float(getattr(want[3][key], field))
                if field in ("l2", "rms", "absmax") and not poison:
                    assert v == pytest.approx(w, rel=RTOL), (key, field)
                else:
                    np.testing.assert_equal(v, w, err_msg=f"{key} {field}")
    with pytest.raises(ValueError, match="unknown compression"):
        OverlappedDataParallel(compress="fp8")
    with pytest.raises(NotImplementedError, match="item 6"):
        dfa.split_params_for_pipe_axis([{}], 2)
    with pytest.raises(NotImplementedError, match="item 6"):
        dfa.consolidate_zero_state_3d([], [], [], dp_world=1, tp_world=1,
                                      pp_world=2)
    with pytest.raises(ValueError, match="overlap=True"):
        overlapped_zero_step([lambda p, h: h], [{}], DistributedFusedAdam(),
                             {"step": 0}, None)
    odp = OverlappedDataParallel()
    sp = _torch_tree(_np_params())
    with pytest.raises(ValueError, match="segment fns"):
        odp.value_and_sync(_torch_segments(torch.zeros(1))[:2], sp,
                           torch.zeros(BATCH, HIDDEN))
    with pytest.raises(ValueError, match="scalar loss"):
        odp.value_and_sync([lambda p, h: h @ p["w0"]], sp[:1],
                           torch.zeros(BATCH, HIDDEN))
