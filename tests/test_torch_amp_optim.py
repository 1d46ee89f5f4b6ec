"""apex_tpu_torch's amp ops, optimizers and loss scalers against
apex_tpu's on the CPU: ``multi_tensor_scale``, ``multi_tensor_axpby``,
``multi_tensor_l2norm_mp`` / ``_scale``, ``multi_tensor_sgd``,
``multi_tensor_adam_capturable`` / ``_capturable_master`` and
``multi_tensor_lamb_mp`` (the kernels' plain versions on CPU tensors);
``FusedSGD``, ``FusedAdam(master_weights=True)``, ``FusedLAMB`` with
``found_inf`` and ``FusedMixedPrecisionLamb`` over three steps, the
second skipped on ``found_inf``; ``LossScaler`` and ``GradScaler`` over a
sequence of overflow flags.

Inputs come from numpy seeds: three tensors of ragged sizes, fp32 or
bf16. The JAX ops and optimizers run op by op, their step counts no
higher than 2: there JAX's eager ``beta ** step`` (``integer_pow``)
equals the traced fp32 power of its jitted step (``beta ** 2`` is one
rounded product), whose values the port's device bias corrections give
(``test_device_bias_corrections_equal_the_host_values`` holds those to
the host's at every step).

Tolerances: scale, axpby, SGD and Adam are the same fp32 operations in
the same order, elementwise, so their outputs, flags, step counts and
states are compared bit for bit. The norms and LAMB's trust ratios are
sums in another order (``torch._foreach_norm`` against XLA's reduce), so
they, and what LAMB moves with them, are held within 1e-6 relative plus
1e-7 absolute, as ``tests/test_torch_optim.py`` holds FusedLAMB; bf16
parameters written from such masters may round one bf16 ulp the other
way (2**-7 relative). A skipped step leaves every tensor bit-identical
on both sides.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.ops import multi_tensor as jax_mt
from apex_tpu.optimizers._base import master_copy_tree as jax_master_copy_tree
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxFMPLamb
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.transformer.amp import GradScaler as JaxGradScaler
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.kernels import _build, registry
from apex_tpu_torch.kernels import optim as optim_kernels
from apex_tpu_torch.kernels import scale as scale_kernels
from apex_tpu_torch.multi_tensor_apply import multi_tensor_applier
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import (
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedSGD,
)
from apex_tpu_torch.optimizers._base import master_copy_tree
from apex_tpu_torch.transformer.amp import GradScaler
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [(7, 5), (1,), (300,)]
LAMB_RTOL, LAMB_ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(seed, scale=1.0, sizes=SIZES, positive=False):
    rng = np.random.RandomState(seed)
    draw = rng.rand if positive else rng.randn
    return [(draw(*s) * scale).astype(np.float32) for s in sizes]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a.copy()).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_host(g), _host(w),
                                      err_msg=f"{what} {k}")


def _close(got, want, what, rtol=LAMB_RTOL, atol=LAMB_ATOL):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_host(g), _host(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


# ------------------------------------------------------------ the ops

PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float32"), ("float32", "bfloat16")]


@pytest.mark.parametrize("planted", [None, "inf", "nan"])
@pytest.mark.parametrize("din,dout", PAIRS)
def test_multi_tensor_scale_matches_jax(din, dout, planted):
    """Each product in fp32, written in out's dtype (a bf16 gradient
    unscaled in place is rounded back to bf16, as JAX's [leaves,
    leaves]); the flag from the fp32 product, not the rounded one."""
    xs = _np(0, 2.0 ** 16)
    if planted:
        xs[2].reshape(-1)[5] = float(planted)
    tin, jin = DTYPES[din]
    tout, jout = DTYPES[dout]
    scale = 2.0 ** -16
    want, flag_j = jax_mt.multi_tensor_scale(
        jnp.zeros((), jnp.float32), [_j(xs, jin), _j(xs, jout)], scale)
    ins, outs = _t(xs, tin), [torch.empty(a.shape, dtype=tout) for a in xs]
    if din == dout:
        outs = ins  # in place, as amp unscales
    flag = torch.zeros(1)
    multi_tensor_applier(mt.multi_tensor_scale, flag, [ins, outs], scale)
    assert flag.item() == float(flag_j) == (1.0 if planted else 0.0)
    assert all(o.dtype == tout for o in outs)
    _equal(outs, want, "out")


def test_multi_tensor_scale_flags_the_fp32_product():
    """bf16's largest finite value times 2 is inf in fp32 before any
    rounding: flagged, as JAX flags it; a raised flag is never cleared."""
    big = np.full((4,), 3.0e38, np.float32)
    flag = torch.ones(1)
    mt.multi_tensor_scale(flag, [[torch.zeros(3)], [torch.zeros(3)]], 1.0)
    assert flag.item() == 1.0
    flag = torch.zeros(1)
    x = [torch.from_numpy(big).to(torch.bfloat16)]
    mt.multi_tensor_scale(flag, [x, x], torch.tensor(2.0))
    _, want = jax_mt.multi_tensor_scale(
        jnp.zeros((), jnp.float32), [[jnp.asarray(big, jnp.bfloat16)]] * 2,
        2.0)
    assert flag.item() == float(want) == 1.0


@pytest.mark.parametrize("planted", [None, "nan"])
@pytest.mark.parametrize("dx,dout", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16")])
def test_multi_tensor_axpby_matches_jax(dx, dout, planted):
    xs, ys = _np(1), _np(2)
    if planted:
        ys[0].reshape(-1)[3] = float(planted)
    tx, jx = DTYPES[dx]
    tout, jout = DTYPES[dout]
    want, flag_j = jax_mt.multi_tensor_axpby(
        jnp.zeros((), jnp.float32), [_j(xs, jx), _j(ys), _j(xs, jout)],
        0.3, -1.7)
    outs = [torch.empty(a.shape, dtype=tout) for a in xs]
    flag = torch.zeros(1)
    mt.multi_tensor_axpby(flag, [_t(xs, tx), _t(ys), outs], 0.3, -1.7)
    assert flag.item() == float(flag_j)
    _equal(outs, want, "out")


def test_multi_tensor_l2norms_match_jax():
    xs = _np(3)
    for dtype in ("float32", "bfloat16"):
        tdt, jdt = DTYPES[dtype]
        got = mt.multi_tensor_l2norm_mp(torch.zeros(1), [_t(xs, tdt)], True)
        want = jax_mt.multi_tensor_l2norm_mp(jnp.zeros(()), [_j(xs, jdt)],
                                             True)
        _close(got, want, f"l2norm_mp {dtype}")
        got = mt.multi_tensor_l2norm_scale(torch.zeros(1), [_t(xs, tdt)],
                                           0.25, True)
        want = jax_mt.multi_tensor_l2norm_scale(
            jnp.zeros(()), [_j(xs, jdt)], 0.25, True)
        _close(got, want, f"l2norm_scale {dtype}")


SGD_CASES = [dict(momentum=0.9), dict(momentum=0.9, nesterov=True, wd=0.01),
             dict(momentum=0.9, dampening=0.1, wd=0.01,
                  wd_after_momentum=True),
             dict(momentum=0.0, wd=0.01)]


@pytest.mark.parametrize("first_run", [True, False])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SGD_CASES)))
def test_multi_tensor_sgd_matches_jax(case, grad_dtype, first_run):
    kw = dict(dict(wd=0.0, momentum=0.0, dampening=0.0, nesterov=False,
                   wd_after_momentum=False), **SGD_CASES[case])
    g, p, m = _np(4, 4.0), _np(5), _np(6, 0.1)
    tdt, jdt = DTYPES[grad_dtype]
    args = (kw["wd"], kw["momentum"], kw["dampening"], 0.05, kw["nesterov"],
            first_run, kw["wd_after_momentum"], 0.25)
    new_p, new_m, _ = jax_mt.multi_tensor_sgd(
        jnp.zeros(()), [_j(g, jdt), _j(p), _j(m)], *args)
    tp, tm = _t(p), _t(m)
    mt.multi_tensor_sgd(torch.zeros(1), [_t(g, tdt), tp, tm], *args)
    _equal(tp, new_p, "p")
    _equal(tm, new_m, "momentum")
    tp, tm = _t(p), _t(m)  # a raised flag leaves everything
    mt.multi_tensor_sgd(torch.ones(1), [_t(g, tdt), tp, tm], *args)
    _equal(tp + tm, _t(p) + _t(m), "skipped")


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,wd", [(1, 0.0), (0, 0.01)])
def test_multi_tensor_adam_capturable_matches_jax(mode, wd, grad_dtype,
                                                  master):
    """The device step (2), the gradients times inv_scale inside the
    update; with masters the bf16 params written from them; a flagged
    call leaves everything."""
    g, p, m, v = _np(7, 2.0 ** 10), _np(8), _np(9, 0.1), _np(10, 0.01,
                                                            positive=True)
    tdt, jdt = DTYPES[grad_dtype]
    hyper = (1e-3, 0.9, 0.999, 1e-8)
    after = (mode, True, wd)

    def jax_op(noop, step):
        if master:
            return jax_mt.multi_tensor_adam_capturable_master(
                noop, [_j(g, jdt), _j(p, jnp.bfloat16), _j(m), _j(v), _j(p)],
                *hyper, step, *after, 2.0 ** -10)
        return jax_mt.multi_tensor_adam_capturable(
            noop, [_j(g, jdt), _j(p), _j(m), _j(v)], *hyper, step, *after,
            2.0 ** -10)

    for flag in (0.0, 1.0):
        want = jax_op(jnp.float32(flag), jnp.int32(2))
        tg, tp, tm, tv = _t(g, tdt), _t(p), _t(m), _t(v)
        if master:
            low = _t(p, torch.bfloat16)
            mt.multi_tensor_adam_capturable_master(
                torch.full((1,), flag), [tg, low, tm, tv, tp], *hyper,
                torch.tensor([2], dtype=torch.int32), *after, 2.0 ** -10)
            _equal(low + tm + tv + tp, [*want[0], *want[1], *want[2],
                                        *want[3]], f"flag {flag}")
        else:
            mt.multi_tensor_adam_capturable(
                torch.full((1,), flag), [tg, tp, tm, tv], *hyper, 2, *after,
                2.0 ** -10)
            _equal(tp + tm + tv, [*want[0], *want[1], *want[2]],
                   f"flag {flag}")


@pytest.mark.parametrize("found", [0.0, 1.0])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd,nvlamb", [(0.01, False), (0.0, True),
                                       (0.0, False)])
def test_multi_tensor_lamb_mp_matches_jax(wd, nvlamb, grad_dtype, found):
    g, p, m, v = _np(11, 64.0), _np(12), _np(13, 0.1), _np(14, 0.01,
                                                          positive=True)
    tdt, jdt = DTYPES[grad_dtype]
    inv = 1.0 / 64.0

    def jax_op(noop, step, found_inf, gnorm):
        return jax_mt.multi_tensor_lamb_mp(
            noop, [_j(g, jdt), _j(p, jnp.bfloat16), _j(m), _j(v), _j(p)],
            1e-3, 0.9, 0.999, 1e-6, step, True, wd, True, 1, gnorm, 1.0,
            nvlamb, found_inf, inv)

    gnorm_t, _ = mt.multi_tensor_l2norm_scale(torch.zeros(1),
                                              [_t(g, tdt)], inv)
    want = jax_op(jnp.float32(0.0), jnp.int32(2), jnp.float32(found),
                  jnp.asarray(gnorm_t.numpy()))
    tp, tm, tv, low = _t(p), _t(m), _t(v), _t(p, torch.bfloat16)
    mt.multi_tensor_lamb_mp(
        torch.zeros(1), [_t(g, tdt), low, tm, tv, tp], 1e-3, 0.9, 0.999,
        1e-6, torch.tensor(2, dtype=torch.int32), True, wd, True, 1, gnorm_t,
        1.0, nvlamb, torch.tensor(found), inv)
    if found:
        _equal(tp + tm + tv + low, _t(p) + _t(m) + _t(v)
               + _t(p, torch.bfloat16), "skipped")
        return
    _close(tm + tv + tp, [*want[1], *want[2], *want[3]], "m, v, masters")
    _close(low, want[0], "bf16 params", rtol=BF16_RTOL, atol=0.0)


def test_device_bias_corrections_equal_the_host_values():
    """The device-step kernels' bias corrections (their plain version:
    the double power of the fp32 beta on the step's device, rounded to
    fp32, subtracted from 1) equal ops.multi_tensor.bias_corrections,
    which tests/test_torch_optim.py holds to JAX's traced power."""
    for k in range(1, 3001):
        got = optim_kernels.device_bias_corrections(
            0.9, 0.999, torch.tensor([k], dtype=torch.int32))
        assert tuple(t.item() for t in got) == mt.bias_corrections(
            0.9, 0.999, k), k


def test_master_copy_tree_never_aliases_as_jax():
    """fp32 masters of a tree of fp32 and bf16 tensors: JAX's values and
    dtypes, each a tensor of its own, also where the leaf was already
    fp32 (JAX's master_copy_tree docstring: a master aliasing its
    parameter is updated twice a step)."""
    a, b = _np(50, sizes=[(3, 2), (4,)])
    tree = {"w": torch.from_numpy(a), "n": [torch.from_numpy(b).bfloat16()]}
    got = master_copy_tree(tree)
    want = jax_master_copy_tree({"w": jnp.asarray(a),
                                 "n": [jnp.asarray(b, jnp.bfloat16)]})
    _equal([got["w"], got["n"][0]], [want["w"], want["n"][0]], "masters")
    assert got["w"].dtype == got["n"][0].dtype == torch.float32
    assert got["w"].data_ptr() != tree["w"].data_ptr()


def test_multi_tensor_applier_passes_through_and_counts_no_launch():
    registry.reset()
    xs = _t(_np(15))
    flag = torch.zeros(1)
    assert multi_tensor_applier(mt.multi_tensor_scale, flag, [xs, xs],
                                0.5) is None
    total, per = multi_tensor_applier(mt.multi_tensor_l2norm, flag, [xs],
                                      True)
    assert per.shape == (len(xs),) and total.ndim == 0
    assert multi_tensor_applier.chunk_size == 2048 * 32
    assert not any(registry.launches().values())


# ------------------------------------------------------ the optimizers

# (grad seed, gradient scale, found_inf): step 2 overflows; step 3's
# gradients arrive scaled by 4 with scale=4
STEPS = [(20, 1.0, 0.0), (21, 1.0, 1.0), (22, 4.0, 0.0)]


def _optimizer_case(name):
    """(JAX optimizer, port optimizer factory, params dtype, exact)."""
    return {
        "sgd": (JaxFusedSGD(lr=0.05, momentum=0.9, weight_decay=0.01),
                lambda ps: FusedSGD(ps, lr=0.05, momentum=0.9,
                                    weight_decay=0.01),
                "float32", True),
        "sgd_nesterov": (
            JaxFusedSGD(lr=0.05, momentum=0.9, nesterov=True,
                        wd_after_momentum=True, weight_decay=0.01),
            lambda ps: FusedSGD(ps, lr=0.05, momentum=0.9, nesterov=True,
                                wd_after_momentum=True, weight_decay=0.01),
            "float32", True),
        "adam_master": (JaxFusedAdam(lr=1e-2, master_weights=True),
                        lambda ps: FusedAdam(ps, lr=1e-2,
                                             master_weights=True),
                        "bfloat16", True),
        "adam": (JaxFusedAdam(lr=1e-2, adam_w_mode=False, weight_decay=0.01),
                 lambda ps: FusedAdam(ps, lr=1e-2, adam_w_mode=False,
                                      weight_decay=0.01),
                 "float32", True),
        "lamb": (JaxFusedLAMB(lr=1e-2), lambda ps: FusedLAMB(ps, lr=1e-2),
                 "float32", False),
        "mp_lamb": (JaxFMPLamb(lr=1e-2), lambda ps: FusedMixedPrecisionLamb(
            ps, lr=1e-2), "bfloat16", False),
    }[name]


@pytest.mark.parametrize("name", ["sgd", "sgd_nesterov", "adam_master",
                                  "adam", "lamb", "mp_lamb"])
def test_optimizer_three_steps_with_a_skipped_one_match_jax(name):
    """Three steps from the same params, the second with found_inf = 1:
    params, moments, masters and step counts after each as JAX's; the
    skipped step changes nothing; the step count advances only on clean
    steps."""
    jopt, make, dtype, exact = _optimizer_case(name)
    tdt, jdt = DTYPES[dtype]
    p0 = _np(30)
    params = [torch.nn.Parameter(t) for t in _t(p0, tdt)]
    topt = make(params)
    jp = _j(p0, jdt)
    js = jopt.init(jp)
    for k, (seed, gscale, found) in enumerate(STEPS):
        g = _np(seed, gscale)
        before = [q.detach().clone() for q in params]
        jp, js = jopt.step(_j(g, jdt), js, jp, found_inf=jnp.float32(found),
                           scale=gscale)
        for q, gk in zip(params, _t(g, tdt)):
            q.grad = gk
        topt.step(found_inf=torch.tensor([found]), scale=gscale)
        topt.zero_grad()
        assert int(topt.param_groups[0]["step"]) == int(js["step"]) == (
            1 if k < 2 else 2), (k, js["step"])
        if found:
            _equal(params, before, f"skipped step {k}")
        check = _equal if exact else _close
        kw = {} if exact else (dict(rtol=BF16_RTOL, atol=0.0)
                               if dtype == "bfloat16" else {})
        check(params, jp, f"params after step {k}", **kw)
        for key in js:
            if key == "step":
                continue
            got = [topt.state[q][key] for q in params]
            check(got, js[key], f"{key} after step {k}",
                  **({} if exact else {}))


# ------------------------------------------------------- the scalers

FLAGS = [0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0]


@pytest.mark.parametrize("kw", [dict(scale_window=3),
                                dict(scale_window=2, min_loss_scale=0.0,
                                     init_scale=0.5),
                                dict(scale_window=2, min_loss_scale=2.0 ** 15),
                                dict(scale_window=1, max_loss_scale=2.0 ** 17),
                                dict(scale_window=3, init_scale=2.0 ** 20,
                                     max_loss_scale=2.0 ** 18)])
def test_loss_scaler_follows_jax_over_a_flag_sequence(kw):
    """The dynamic scale and the clean-step count after each flag as
    JAX's: halve on an overflow down to the floor (0 is a legal floor),
    double after scale_window clean steps up to max_loss_scale."""
    port = LossScaler("dynamic", device="cpu", **kw)
    ref = JaxLossScaler("dynamic", **kw)
    ts, js = port.init_state(), ref.init_state()
    assert float(ts.loss_scale) == float(js.loss_scale)
    for k, f in enumerate(FLAGS):
        ts = port.update(ts, torch.tensor([float(f)]))
        js = ref.update(js, jnp.float32(f))
        assert ts.loss_scale.dtype == torch.float32
        assert ts.unskipped.dtype == torch.int32
        assert (float(ts.loss_scale), int(ts.unskipped)) == (
            float(js.loss_scale), int(js.unskipped)), (k, ts, js)
    static = LossScaler(128.0, device="cpu")
    state = static.init_state()
    assert static.update(state, torch.ones(1)) is state


def test_grad_scaler_follows_jax_without_floor_or_clamp():
    """GradScaler's update as JAX's: backoff on an overflow with no floor,
    growth with no max_loss_scale clamp (reproduced, not fixed); at one
    rank its found_inf all-reduce is the identity."""
    kw = dict(init_scale=2.0 ** 23, growth_factor=2.0, backoff_factor=0.25,
              growth_interval=2)
    port, ref = GradScaler(device="cpu", **kw), JaxGradScaler(**kw)
    ts, js = port.init_state(), ref.init_state()
    scales = []
    for k, f in enumerate([0] * 6 + [1] * 14 + [0]):
        ts = port.update(ts, torch.tensor([float(f)]))
        js = ref.update(js, jnp.float32(f))
        assert (float(ts.loss_scale), int(ts.unskipped)) == (
            float(js.loss_scale), int(js.unskipped)), (k, ts, js)
        scales.append(float(ts.loss_scale))
    assert max(scales) == 2.0 ** 26 and min(scales) == 2.0 ** -2, scales
    grads = _t(_np(40, 1024.0))
    grads[1][0] = float("inf")
    got, found = port.unscale_grads(grads, port.init_state())
    assert found.item() == 1.0 and got[0].dtype == torch.float32


def test_loss_scaler_eager_api_and_telemetry_placeholder():
    sc = LossScaler("dynamic", device="cpu", scale_window=2)
    assert sc.loss_scale() == 2.0 ** 16
    g = _t(_np(41, 2.0 ** 16))
    want = [t / 2.0 ** 16 for t in g]
    sc.unscale(g)
    _equal(g, want, "unscaled")
    assert sc.update_scale() is False
    g[0][0] = float("nan")
    sc.unscale(g)
    assert sc.update_scale() is True and sc.loss_scale() == 2.0 ** 15
    sd = sc.state_dict()
    assert sd == {"loss_scale": 2.0 ** 15, "unskipped": 0, "dynamic": True}
    other = LossScaler("dynamic", device="cpu")
    other.load_state_dict(sd)
    assert other.state_dict() == sd
    # the telemetry: the same update sequence lands the same gauge,
    # counters and events as JAX's eager scaler (timestamps aside)
    from apex_tpu.telemetry import MetricsRegistry as JaxRegistry
    from apex_tpu.telemetry import use_registry as jax_use_registry
    from apex_tpu_torch.telemetry import MetricsRegistry, use_registry

    flags = [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    recs = []
    for make, use, scaler, flag_of in (
            (JaxRegistry, jax_use_registry,
             JaxLossScaler("dynamic", scale_window=2),
             lambda f: jnp.float32(f)),
            (MetricsRegistry, use_registry,
             LossScaler("dynamic", device="cpu", scale_window=2),
             lambda f: torch.full((1,), f))):
        events = []
        with use(make(enabled=True)) as reg:
            reg.add_event_tap(events.append)
            state = scaler._state
            for f in flags:
                state = scaler.update(state, flag_of(f))
            snap = reg.snapshot()
        recs.append(([{k: v for k, v in e.items() if k not in ("t", "ts")}
                      for e in events],
                     snap["counters"], snap["gauges"]))
    assert recs[1] == recs[0]
    assert recs[0][1] == {"amp/overflow": 1.0,
                          "amp/scale_window_growth": 2.0}
    # disabled (the default): nothing is recorded
    with use_registry(MetricsRegistry()) as reg:
        sc.record_update(sc._state, sc._state, torch.ones(1))
        assert reg.snapshot()["counters"] == {}


# ------------------------------------------------- the C interfaces

_CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


def _c_argtypes(lib, symbol):
    """The ctypes types of C function ``symbol``'s parameters in
    csrc/<lib>.cu: a pointer c_void_p, else by type."""
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)',
                       (_CSRC / f"{lib}.cu").read_text()).group(1)
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        else:
            kinds.append({"float": ctypes.c_float, "int": ctypes.c_int}[
                param.rsplit(" ", 1)[0].removeprefix("const ")])
    return kinds


@pytest.mark.parametrize("module,loader", [
    (scale_kernels, "_kernel"), (optim_kernels, "_kernel"),
    (optim_kernels, "_sgd_kernel"), (optim_kernels, "_lamb_kernel"),
    (optim_kernels, "_lamb_stage2_kernel")])
def test_ctypes_signatures_match_the_c_functions(monkeypatch, module,
                                                 loader):
    """The argument types amp's kernel loaders hand ``_build.function``
    (nothing is built) against the C definitions: multi_tensor_scale.cu,
    adam.cu (with its device step, inv_scale and outputs), sgd.cu and
    lamb.cu's two stages."""
    monkeypatch.setattr(_build, "function", lambda lib, symbol, types: (
        lib, symbol, list(types)))
    lib, symbol, types = getattr(module, loader).__wrapped__()
    assert types == _c_argtypes(lib, symbol)
