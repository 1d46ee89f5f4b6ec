"""apex_tpu_torch Adam (kernels/optim, ops/multi_tensor, optimizers
FusedAdam, models/params load_jax_adam_state) against apex_tpu's on the
CPU.

The port's wrapper takes its plain PyTorch version for CPU tensors; the
JAX side runs ``apex_tpu.kernels.optim.fused_adam_update`` as a Pallas
kernel in interpret mode, and ``multi_tensor_adam`` / ``FusedAdam`` as
the jnp code the JAX optimizer runs. Inputs come from numpy seeds.

Tolerances: the update is the same fp32 operations in the same order,
elementwise with no sums, so results are compared for equality where
the JAX side is the kernel or the op run eagerly; the jit-compiled JAX
``FusedAdam`` may contract its expressions differently, so trajectories
over several steps are held within 1e-6 relative (a few fp32 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import optim as jax_optim
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.ops import multi_tensor_adam as jax_multi_tensor_adam
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.kernels import optim as port_kernels
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models.params import load_jax_adam_state
from apex_tpu_torch.ops.multi_tensor import (
    bias_corrections,
    multi_tensor_adam,
)
from apex_tpu_torch.optimizers import FusedAdam

SHAPES = [(4, 5), (7,), (3, 2, 6), (1,)]


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["adam"])
    yield
    reg.force_interpret(False, ["adam"])


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
    load_jax_adam_state(opt, model, jax.tree.map(np.asarray, state))
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
        load_jax_adam_state(opt, model, state)


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
