"""apex_tpu_torch Adam and LAMB (kernels/optim, ops/multi_tensor,
optimizers FusedAdam and FusedLAMB, models/params
load_jax_optimizer_state) against apex_tpu's on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the JAX side runs ``apex_tpu.kernels.optim.fused_adam_update`` and
``fused_lamb_mvu`` as Pallas kernels in interpret mode, and
``multi_tensor_adam`` / ``multi_tensor_lamb`` / ``FusedAdam`` /
``FusedLAMB`` as the jnp code the JAX optimizers run. Inputs come from
numpy seeds.

Tolerances: the Adam update and LAMB's moments and raw update are the
same fp32 operations in the same order, elementwise with no sums, so
results are compared for equality where the JAX side is the kernel or
the op run eagerly; the jit-compiled JAX optimizers may contract their
expressions differently, so trajectories over several steps are held
within 1e-6 relative (a few fp32 ulps). LAMB's norms (the global
gradient norm, each tensor's ||p|| and ||update||) are sums in another
order, so ``multi_tensor_lamb`` and ``FusedLAMB`` are held within 1e-6
relative plus 1e-7 absolute too (measured: parameters of magnitude ~1
within 2.4e-7 absolute, one or two fp32 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import optim as jax_optim
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.ops import multi_tensor_adam as jax_multi_tensor_adam
from apex_tpu.ops import multi_tensor_l2norm as jax_multi_tensor_l2norm
from apex_tpu.ops import multi_tensor_lamb as jax_multi_tensor_lamb
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch.kernels import optim as port_kernels
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models.params import load_jax_optimizer_state
from apex_tpu_torch.ops.multi_tensor import (
    bias_corrections,
    multi_tensor_adam,
    multi_tensor_l2norm,
    multi_tensor_lamb,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

SHAPES = [(4, 5), (7,), (3, 2, 6), (1,)]


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["adam", "lamb"])
    yield
    reg.force_interpret(False, ["adam", "lamb"])


def _arrays(seed, shapes=SHAPES):
    """g, p, m, v lists of fp32 numpy arrays (v >= 0)."""
    rng = np.random.RandomState(seed)
    g = [rng.randn(*s).astype(np.float32) for s in shapes]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    m = [0.1 * rng.randn(*s).astype(np.float32) for s in shapes]
    v = [0.01 * rng.rand(*s).astype(np.float32) for s in shapes]
    return g, p, m, v


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_update_plain_matches_jax_kernel(adam_w, wd):
    g, p, m, v = (np.concatenate([a.ravel() for a in t])
                  for t in _arrays(1))
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
              adam_w=adam_w)
    bc1, bc2 = bias_corrections(0.9, 0.999, 3)
    want = jax_optim.fused_adam_update(
        jnp.asarray(g), jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
        bc1=bc1, bc2=bc2, **kw)
    got = port_kernels.fused_adam_update_plain(
        torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(m),
        torch.from_numpy(v), bc1=torch.tensor(bc1), bc2=torch.tensor(bc2),
        **kw)
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_bias_corrections_match_jnp():
    """``1 - beta**step`` as jnp computes it from an int32 step."""
    steps = jnp.arange(1, 101, dtype=jnp.int32)
    for b1, b2 in ((0.9, 0.999), (0.8, 0.95)):
        want1 = np.asarray(1.0 - b1 ** steps)
        want2 = np.asarray(1.0 - b2 ** steps)
        got = np.array([bias_corrections(b1, b2, s) for s in range(1, 101)],
                       dtype=np.float32)
        np.testing.assert_array_equal(got[:, 0], want1)
        np.testing.assert_array_equal(got[:, 1], want2)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("step", [1, 4])
def test_multi_tensor_adam_matches_jax(mode, wd, bias_correction, step):
    g, p, m, v = _arrays(2)
    want_p, want_m, want_v, _ = jax_multi_tensor_adam(
        jnp.zeros((), jnp.float32),
        [[jnp.asarray(a) for a in t] for t in (g, p, m, v)],
        1e-3, 0.9, 0.999, 1e-8, jnp.asarray(step, jnp.int32), mode,
        bias_correction, wd)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    multi_tensor_adam(torch.zeros(1), [_torch(g), tp, tm, tv], 1e-3, 0.9,
                      0.999, 1e-8, step, mode, bias_correction, wd)
    for got, want in ((tp, want_p), (tm, want_m), (tv, want_v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_noop_flag_leaves_state_bit_identical():
    g, p, m, v = _arrays(3)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    multi_tensor_adam(torch.ones(1), [_torch(g), tp, tm, tv], 1e-3, 0.9,
                      0.999, 1e-8, 1, 1, True, 0.01)
    for got, want in ((tp, p), (tm, m), (tv, v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), w)


def test_multi_tensor_adam_rejects_bad_mode():
    with pytest.raises(ValueError, match="mode"):
        multi_tensor_adam(torch.zeros(1), [[], [], [], []], 1e-3, 0.9,
                          0.999, 1e-8, 1, 2, True, 0.0)


def _jax_trajectory(p0, grads, **kw):
    """Params after each step of the JAX FusedAdam fed ``grads``."""
    opt = JaxFusedAdam(**kw)
    params = {f"t{i}": jnp.asarray(a) for i, a in enumerate(p0)}
    state = opt.init(params)
    step = jax.jit(opt.step)
    out = []
    for gs in grads:
        params, state = step({f"t{i}": jnp.asarray(a)
                              for i, a in enumerate(gs)}, state, params)
        out.append([np.asarray(params[f"t{i}"]) for i in range(len(p0))])
    return out, state


@pytest.mark.parametrize("adam_w_mode,wd", [(True, 0.0), (True, 0.01),
                                             (False, 0.01)])
def test_fused_adam_trajectory_matches_jax(adam_w_mode, wd):
    _, p0, _, _ = _arrays(4)
    grads = [_arrays(10 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, adam_w_mode=adam_w_mode,
              weight_decay=wd)
    want, _ = _jax_trajectory(p0, grads, **kw)
    params = [torch.nn.Parameter(t) for t in _torch(p0)]
    opt = FusedAdam(params, **kw)
    for k, gs in enumerate(grads):
        for prm, gr in zip(params, gs):
            prm.grad = torch.from_numpy(gr)
        opt.step()
        opt.zero_grad()
        for prm, w in zip(params, want[k]):
            np.testing.assert_allclose(prm.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-7)
    assert opt.param_groups[0]["step"] == 3
    assert all(prm.grad is None for prm in params)


def test_load_jax_adam_state_continues_the_jax_trajectory():
    """The port's optimizer started from the JAX state after two steps
    takes the JAX optimizer's third step."""
    _, p0, _, _ = _arrays(5)
    grads = [_arrays(20 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01)
    want, _ = _jax_trajectory(p0, grads, **kw)
    _, state = _jax_trajectory(p0, grads[:2], **kw)
    model = torch.nn.ParameterDict(
        {f"t{i}": torch.nn.Parameter(torch.from_numpy(a.copy()))
         for i, a in enumerate(want[1])})
    opt = FusedAdam(model.parameters(), **kw)
    load_jax_optimizer_state(opt, model, jax.tree.map(np.asarray, state))
    assert opt.param_groups[0]["step"] == 2
    for i, gr in enumerate(grads[2]):
        model[f"t{i}"].grad = torch.from_numpy(gr)
    opt.step()
    for i, w in enumerate(want[2]):
        np.testing.assert_allclose(model[f"t{i}"].detach().numpy(), w,
                                   rtol=1e-6, atol=1e-7)


def test_load_jax_adam_state_rejects_other_names():
    model = torch.nn.ParameterDict({"a": torch.nn.Parameter(torch.zeros(3))})
    opt = FusedAdam(model.parameters())
    state = {"step": np.int32(1), "exp_avg": {"b": np.zeros(3, np.float32)},
             "exp_avg_sq": {"b": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="do not match"):
        load_jax_optimizer_state(opt, model, state)


def test_fused_adam_refuses_what_it_does_not_have():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)
    with pytest.raises(NotImplementedError, match="amp slice"):
        FusedAdam(p, master_weights=True)
    opt = FusedAdam(p)
    p[0].grad = torch.ones(3)
    with pytest.raises(NotImplementedError, match="amp slice"):
        opt.step(found_inf=torch.zeros(1))
    with pytest.raises(NotImplementedError, match="amp slice"):
        opt.step(scale=128.0)
    assert opt.param_groups[0]["step"] == 0


def test_fused_adam_skips_parameters_without_grad():
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    opt = FusedAdam([a, b], lr=0.1)
    a.grad = torch.ones(3)
    opt.step()
    assert not torch.equal(a.detach(), torch.ones(3))
    assert torch.equal(b.detach(), torch.ones(2)) and b not in opt.state


def test_plain_version_counts_no_launch():
    registry.reset()
    g, p, m, v = (_torch(t) for t in _arrays(6))
    multi_tensor_adam(torch.zeros(1), [g, p, m, v], 1e-3, 0.9, 0.999, 1e-8,
                      1, 1, True, 0.0)
    assert registry.launches()["adam"] == 0


def test_wrapper_checks_lists_and_devices():
    g, p, m, v = (_torch(t) for t in _arrays(7))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.adam(torch.zeros(1, device="meta"), g, p, m, v,
                          lr=1e-3, bc1=1.0, bc2=1.0, b1=0.9, b2=0.999,
                          eps=1e-8, weight_decay=0.0, adam_w=True)


# -------------------------------------------------------------------- LAMB

@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("grad_averaging", [True, False])
def test_fused_lamb_mvu_plain_matches_jax_kernel(adam_w, wd, grad_averaging):
    """Against the interpreted Pallas kernel within 4 fp32 ulps (XLA's
    CPU compiler contracts the kernel's ``b1 * m + beta3 * g`` into an
    FMA: measured 18 of 64 moments one ulp apart, and updates up to two
    ulps apart after ``+ wd * p``), and against the same
    JAX function with its gate off (its jnp oracle, run op by op, which
    the CUDA kernel's round-to-nearest intrinsics follow) for equality."""
    g, p, m, v = (np.concatenate([a.ravel() for a in t])
                  for t in _arrays(31))
    beta3 = 0.1 if grad_averaging else 1.0
    kw = dict(b1=0.9, b2=0.999, beta3=beta3, eps=1e-6, weight_decay=wd,
              adam_w=adam_w)
    bc1, bc2 = bias_corrections(0.9, 0.999, 2)
    args = [jnp.asarray(a) for a in (g, p, m, v)]
    want = jax_optim.fused_lamb_mvu(*args, bc1=bc1, bc2=bc2, **kw)
    got = port_kernels.fused_lamb_mvu_plain(
        torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(m),
        torch.from_numpy(v), bc1=torch.tensor(bc1), bc2=torch.tensor(bc2),
        **kw)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=2.0 ** -21,
                                   atol=0)
    get_kernel_registry().force_interpret(False, ["lamb"])
    oracle = jax_optim.fused_lamb_mvu(*args, bc1=jnp.float32(bc1),
                                      bc2=jnp.float32(bc2), **kw)
    for t, w in zip(got, oracle):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_lamb_plain_clips_writes_the_update_into_g_and_honours_noop():
    g, p, m, v = _arrays(32)
    kw = dict(bc1=0.1, bc2=0.001, b1=0.9, b2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, adam_w=True)
    clip = torch.tensor([2.5])
    tg, tm, tv = _torch(g), _torch(m), _torch(v)
    port_kernels.lamb(torch.zeros(1), tg, _torch(p), tm, tv, clip=clip, **kw)
    for k in range(len(g)):
        want = port_kernels.fused_lamb_mvu_plain(
            torch.from_numpy(g[k]) / clip[0], torch.from_numpy(p[k]),
            torch.from_numpy(m[k]), torch.from_numpy(v[k]),
            **dict(kw, bc1=torch.tensor(0.1), bc2=torch.tensor(0.001)))
        for got, w in zip((tm[k], tv[k], tg[k]), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
    tg, tm, tv = _torch(g), _torch(m), _torch(v)
    port_kernels.lamb(torch.ones(1), tg, _torch(p), tm, tv, clip=clip, **kw)
    for got, want in ((tg, g), (tm, m), (tv, v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), w)


def test_multi_tensor_l2norm_matches_jax():
    xs = _arrays(33)[0]
    want, want_per = jax_multi_tensor_l2norm(
        jnp.zeros((), jnp.float32), [[jnp.asarray(a) for a in xs]], True)
    got, got_per = multi_tensor_l2norm(torch.zeros(1), [_torch(xs)], True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got_per.numpy(), np.asarray(want_per),
                               rtol=1e-6)
    assert multi_tensor_l2norm(torch.zeros(1), [_torch(xs)])[1] is None


# (mode, weight_decay, use_nvlamb, max_grad_norm): the grads' global norm
# is ~8, so 1.0 clips and 100.0 does not
LAMB_CASES = [(1, 0.01, False, 1.0), (1, 0.01, False, 100.0),
              (0, 0.01, False, 1.0), (1, 0.0, False, 1.0),
              (1, 0.0, True, 1.0), (0, 0.0, True, 100.0), (1, 0.01, True, 0.0)]


@pytest.mark.parametrize("mode,wd,nvlamb,max_norm", LAMB_CASES)
@pytest.mark.parametrize("step", [1, 3])
def test_multi_tensor_lamb_matches_jax(mode, wd, nvlamb, max_norm, step):
    g, p, m, v = _arrays(34)
    gnorm = float(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for a in g)))
    want_p, want_m, want_v, _ = jax_multi_tensor_lamb(
        jnp.zeros((), jnp.float32),
        [[jnp.asarray(a) for a in t] for t in (g, p, m, v)],
        1e-2, 0.9, 0.999, 1e-6, jnp.asarray(step, jnp.int32), True, wd,
        True, mode, jnp.float32(gnorm), max_norm, nvlamb)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    multi_tensor_lamb(torch.zeros(1), [_torch(g), tp, tm, tv], 1e-2, 0.9,
                      0.999, 1e-6, step, True, wd, True, mode,
                      torch.tensor(gnorm), max_norm, nvlamb)
    for got, want in ((tm, want_m), (tv, want_v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    for t, w in zip(tp, want_p):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_multi_tensor_lamb_noop_leaves_everything_bit_identical():
    g, p, m, v = _arrays(35)
    g[0][0, 0] = np.inf  # an overflowed step: skipped, not NaN-poisoned
    lists = [_torch(t) for t in (g, p, m, v)]
    multi_tensor_lamb(torch.ones(1), lists, 1e-2, 0.9, 0.999, 1e-6, 1, True,
                      0.01, True, 1, torch.tensor(8.0), 1.0, False)
    for got, want in zip(lists, (g, p, m, v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), w)


def _jax_lamb_trajectory(p0, grads, **kw):
    """Params after each step of the JAX FusedLAMB fed ``grads``."""
    opt = JaxFusedLAMB(**kw)
    params = {f"t{i}": jnp.asarray(a) for i, a in enumerate(p0)}
    state = opt.init(params)
    step = jax.jit(opt.step)
    out = []
    for gs in grads:
        params, state = step({f"t{i}": jnp.asarray(a)
                              for i, a in enumerate(gs)}, state, params)
        out.append([np.asarray(params[f"t{i}"]) for i in range(len(p0))])
    return out, state


FUSED_LAMB_CASES = [
    dict(adam_w_mode=True, weight_decay=0.01, max_grad_norm=1.0),
    dict(adam_w_mode=True, weight_decay=0.01, max_grad_norm=100.0),
    dict(adam_w_mode=False, weight_decay=0.01, max_grad_norm=1.0),
    dict(adam_w_mode=True, weight_decay=0.0, max_grad_norm=1.0),
    dict(adam_w_mode=True, weight_decay=0.0, use_nvlamb=True),
    dict(adam_w_mode=False, weight_decay=0.0, max_grad_norm=100.0,
         use_nvlamb=True),
    dict(adam_w_mode=True, weight_decay=0.01, bias_correction=False,
         grad_averaging=False),
]


@pytest.mark.parametrize("kw", FUSED_LAMB_CASES)
def test_fused_lamb_trajectory_matches_jax(kw):
    _, p0, _, _ = _arrays(36)
    grads = [_arrays(40 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-6, **kw)
    want, _ = _jax_lamb_trajectory(p0, grads, **kw)
    params = [torch.nn.Parameter(t) for t in _torch(p0)]
    opt = FusedLAMB(params, **kw)
    for k, gs in enumerate(grads):
        for prm, gr in zip(params, gs):
            prm.grad = torch.from_numpy(gr.copy())
        opt.step()
        opt.zero_grad()
        for prm, w in zip(params, want[k]):
            np.testing.assert_allclose(prm.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-7)
    assert opt.param_groups[0]["step"] == 3
    assert all(prm.grad is None for prm in params)


def test_fused_lamb_leaves_the_update_in_grad_until_zero_grad():
    p = torch.nn.Parameter(torch.ones(4))
    opt = FusedLAMB([p], lr=0.1, set_grad_none=False)
    g = torch.tensor([1.0, -2.0, 0.5, 0.0])
    p.grad = g.clone()
    opt.step()
    assert not torch.equal(p.grad, g)  # the raw update, not the gradient
    opt.zero_grad()
    assert torch.equal(p.grad, torch.zeros(4))


def test_load_jax_optimizer_state_continues_the_jax_lamb_trajectory():
    """The port's FusedLAMB started from the JAX state after two steps
    takes the JAX optimizer's third step."""
    _, p0, _, _ = _arrays(37)
    grads = [_arrays(50 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-6, weight_decay=0.01)
    want, _ = _jax_lamb_trajectory(p0, grads, **kw)
    _, state = _jax_lamb_trajectory(p0, grads[:2], **kw)
    model = torch.nn.ParameterDict(
        {f"t{i}": torch.nn.Parameter(torch.from_numpy(a.copy()))
         for i, a in enumerate(want[1])})
    opt = FusedLAMB(model.parameters(), **kw)
    load_jax_optimizer_state(opt, model, jax.tree.map(np.asarray, state))
    assert opt.param_groups[0]["step"] == 2
    for i, gr in enumerate(grads[2]):
        model[f"t{i}"].grad = torch.from_numpy(gr.copy())
    opt.step()
    for i, w in enumerate(want[2]):
        np.testing.assert_allclose(model[f"t{i}"].detach().numpy(), w,
                                   rtol=1e-6, atol=1e-7)


def test_fused_lamb_refuses_what_it_does_not_have():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(p, amsgrad=True)
    opt = FusedLAMB(p)
    p[0].grad = torch.ones(3)
    with pytest.raises(NotImplementedError, match="amp slice"):
        opt.step(found_inf=torch.zeros(1))
    with pytest.raises(NotImplementedError, match="amp slice"):
        opt.step(scale=128.0)
    assert opt.param_groups[0]["step"] == 0
    with pytest.raises(ValueError, match="mode"):
        multi_tensor_lamb(torch.zeros(1), [[], [], [], []], 1e-3, 0.9, 0.999,
                          1e-6, 1, True, 0.0, True, 2, 1.0, 1.0)


def test_lamb_plain_version_counts_no_launch():
    registry.reset()
    g, p, m, v = (_torch(t) for t in _arrays(38))
    multi_tensor_lamb(torch.zeros(1), [g, p, m, v], 1e-3, 0.9, 0.999, 1e-6,
                      1, True, 0.01, True, 1, torch.tensor(3.0), 1.0)
    assert registry.launches()["lamb"] == 0


def test_lamb_wrapper_checks_devices():
    g, p, m, v = (_torch(t) for t in _arrays(39))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.lamb(torch.zeros(1, device="meta"), g, p, m, v,
                          clip=None, bc1=1.0, bc2=1.0, b1=0.9, b2=0.999,
                          beta3=0.1, eps=1e-6, weight_decay=0.0, adam_w=True)
