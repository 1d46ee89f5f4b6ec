"""apex_tpu_torch's public two-stage LAMB ops (``multi_tensor_lamb_stage1``
and ``multi_tensor_lamb_stage2``, on the LAMB kernels' plain versions
for CPU tensors) against apex_tpu's on the CPU, and the stage-1 kernel's
per-tensor-decay route (one launch a distinct decay) on the CPU with the
C function replaced by a recorder.

Inputs come from numpy seeds: four tensors of ragged sizes. The JAX ops
run op by op at step 2, where JAX's eager ``beta ** step`` equals the
traced fp32 power that the port's device step gives
(``tests/test_torch_amp_optim.py``).

Tolerances: stage 1 is the same fp32 operations in the same order,
elementwise, so moments and updates are compared bit for bit. Stage 2's
trust ratios are norms, sums in another order (``torch._foreach_norm``
against XLA's reduce), so parameters where the ratio applies are held
within 1e-6 relative plus 1e-7 absolute, as ``tests/test_torch_optim.py``
holds FusedLAMB; where it does not apply (decay 0 without NVLAMB) they
are compared bit for bit. The two stages composed equal the port's fused
op bit for bit (the same plain versions and norms).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import multi_tensor as jax_mt
from apex_tpu_torch.kernels import _checks
from apex_tpu_torch.kernels import optim
from apex_tpu_torch.ops import multi_tensor as mt
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [(7, 5), (1,), (300,), (4, 3, 2)]
DECAYS = [0.0, 0.01, 0.01, 0.0]
RTOL, ATOL = 1e-6, 1e-7


def _np(seed, scale=1.0, positive=False):
    rng = np.random.RandomState(seed)
    draw = rng.rand if positive else rng.randn
    return [(draw(*s) * scale).astype(np.float32) for s in SIZES]


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_host(g), _host(w),
                                      err_msg=f"{what} {k}")


def _close(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_host(g), _host(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def _state(seed):
    return (_np(seed), _np(seed + 1), _np(seed + 2, 0.1),
            _np(seed + 3, 0.01, positive=True))


STAGE1_CASES = {
    "mixed_decay_mode1": dict(mode=1),
    "mixed_decay_mode0": dict(mode=0),
    "beta3_given": dict(mode=1, beta3=0.5),
    "no_averaging": dict(mode=1, grad_averaging=False),
    "clipped": dict(mode=1, clip=True),
    "clipped_mode0_beta3": dict(mode=0, clip=True, beta3=0.25),
    "no_bias_correction": dict(mode=1, bias_correction=False),
}


@pytest.mark.parametrize("case", sorted(STAGE1_CASES))
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_stage1_matches_jax_bit_for_bit(case, noop):
    """Stage 1 with a mixed per-tensor decay (0 and 0.01 in one list):
    exp_avgs, exp_avg_sqs and the updates as JAX's, bit for bit; a raised
    flag keeps the moments (and writes no update)."""
    c = dict(STAGE1_CASES[case])
    g, p, m, v = _state(10)
    gnorm = np.float32(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2)
                                   for a in g)))
    max_norm = 0.5 if c.pop("clip", False) else 0.0
    kw = dict(beta1=0.9, beta2=0.99, beta3=c.pop("beta3", None),
              bias_correction=c.pop("bias_correction", True), eps=1e-6,
              grad_averaging=c.pop("grad_averaging", True), mode=c.pop("mode"))
    want_m, want_v, want_u, _ = jax_mt.multi_tensor_lamb_stage1(
        jnp.float32(noop), [_j(g), _j(p), _j(m), _j(v), [None] * 4], DECAYS,
        jnp.int32(2), global_grad_norm=jnp.float32(gnorm),
        max_global_grad_norm=max_norm, **kw)
    tm, tv = _t(m), _t(v)
    tu = [torch.full(s, 7.0) for s in SIZES]
    mt.multi_tensor_lamb_stage1(
        torch.tensor([noop]), [_t(g), _t(p), tm, tv, tu], DECAYS,
        torch.tensor([2], dtype=torch.int32),
        global_grad_norm=torch.tensor(gnorm),
        max_global_grad_norm=max_norm, **kw)
    _equal(tm, want_m if not noop else m, "exp_avg")
    _equal(tv, want_v if not noop else v, "exp_avg_sq")
    if noop:
        _equal(tu, [np.full(s, 7.0, np.float32) for s in SIZES], "updates")
    else:
        _equal(tu, want_u, "updates")


@pytest.mark.parametrize("use_nvlamb", [False, True])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_stage2_matches_jax_with_the_per_tensor_trust_gate(use_nvlamb,
                                                           noop):
    """Stage 2: each tensor moves by lr * ratio * update, the trust ratio
    only where use_nvlamb or that tensor's decay is not 0 (JAX's gate,
    tensor by tensor); the ungated tensors bit for bit, the gated within
    RTOL/ATOL; a raised flag keeps every parameter."""
    p, u = _np(20), _np(21, 0.1)
    want, _ = jax_mt.multi_tensor_lamb_stage2(
        jnp.float32(noop), [_j(p), _j(u)], DECAYS, 0.02,
        use_nvlamb=use_nvlamb)
    tp = _t(p)
    mt.multi_tensor_lamb_stage2(torch.tensor([noop]), [tp, _t(u)], DECAYS,
                                0.02, use_nvlamb=use_nvlamb)
    if noop:
        _equal(tp, p, "kept params")
        return
    for k, wd in enumerate(DECAYS):
        gated = use_nvlamb or wd != 0
        (_close if gated else _equal)([tp[k]], [want[k]], f"param {k}")
    if not use_nvlamb:  # the ungated move is lr * update exactly
        moved = [a - np.float32(0.02) * b for a, b in zip(p, u)]
        _equal([tp[0], tp[3]], [moved[0], moved[3]], "ungated params")


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("mode", [0, 1])
def test_stages_composed_equal_the_fused_op(wd, mode):
    """Stage 1 into update buffers, then stage 2, equal the port's fused
    ``multi_tensor_lamb`` bit for bit (parameters, moments), and JAX's
    fused op within RTOL/ATOL, as tests/L0/test_multi_tensor.py composes
    JAX's stages."""
    g, p, m, v = _state(30)
    gnorm = np.float32(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2)
                                   for a in g)))
    kw = dict(beta1=0.9, beta2=0.99, eps=1e-6, bias_correction=True,
              grad_averaging=True, mode=mode)
    step = torch.tensor([2], dtype=torch.int32)
    fp, fm, fv, fg = _t(p), _t(m), _t(v), _t(g)
    mt.multi_tensor_lamb(torch.zeros(1), [fg, fp, fm, fv], 0.01, kw["beta1"],
                         kw["beta2"], kw["eps"], step, True, wd, True, mode,
                         torch.tensor(gnorm), 1.0)
    sp, sm, sv = _t(p), _t(m), _t(v)
    su = [torch.empty(s) for s in SIZES]
    decays = [wd] * len(SIZES)
    mt.multi_tensor_lamb_stage1(
        torch.zeros(1), [_t(g), sp, sm, sv, su], decays, step,
        beta3=None, global_grad_norm=torch.tensor(gnorm),
        max_global_grad_norm=1.0, **kw)
    mt.multi_tensor_lamb_stage2(torch.zeros(1), [sp, su], decays, 0.01)
    _equal(sp + sm + sv, fp + fm + fv, "stages against the fused op")
    want_p, want_m, want_v, _ = jax_mt.multi_tensor_lamb(
        jnp.float32(0.0), [_j(g), _j(p), _j(m), _j(v)], 0.01, 0.9, 0.99,
        1e-6, jnp.int32(2), True, wd, True, mode, jnp.float32(gnorm), 1.0)
    _close(sp + sm + sv, [*want_p, *want_m, *want_v], "stages against JAX")


def test_stages_refuse_bf16_parameters():
    """The LAMB kernels move fp32 parameters: bf16 ones are refused, the
    error naming the dtype (JAX casts its update back to bf16; keep fp32
    masters here)."""
    g, p, m, v = (_t(x) for x in _state(40))
    bf = [t.bfloat16() for t in p]
    with pytest.raises(TypeError, match="bfloat16"):
        mt.multi_tensor_lamb_stage1(
            torch.zeros(1), [g, bf, m, v, [torch.empty_like(t) for t in p]],
            DECAYS, 1, 0.9, 0.99, None, True, 1e-6, True, 1, 1.0, 1.0)
    with pytest.raises(TypeError, match="bfloat16"):
        mt.multi_tensor_lamb_stage2(torch.zeros(1), [bf, m], DECAYS, 0.01)


@pytest.fixture
def recorded(monkeypatch):
    """The stage-1 C function replaced by a recorder; CUDA contexts and
    streams by stand-ins, so ``launch_lamb`` runs on CPU tensors."""
    calls = []

    def recorder(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(optim, "_lamb_kernel", lambda: recorder)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    return calls


def test_per_tensor_decay_takes_one_launch_a_distinct_value(recorded):
    """``launch_lamb`` with a per-tensor decay makes one run a distinct
    value, in the order the values first appear, each launch holding
    exactly that value's tensors and passing it as the kernel's wd; one
    number makes the launches it always made."""
    g, p, m, v = (_t(x) for x in _state(50))
    decays = [0.0, 0.01, 0.02, 0.01]
    kw = dict(clip=None, b1=0.9, b2=0.99, beta3=0.1, eps=1e-6, adam_w=True,
              bc1=0.19, bc2=0.0199)
    n = optim.launch_lamb(torch.zeros(1), g, p, m, v, None,
                          weight_decay=decays, **kw)
    assert n == len(recorded) == 3
    for call, wd, index in zip(recorded, (0.0, 0.01, 0.02),
                               ([0], [1, 3], [2])):
        table_g, count, decay = call[0], call[6], call[20]
        assert count == len(index) and decay == pytest.approx(wd)
        assert list(table_g) == [g[k].data_ptr() for k in index]
    recorded.clear()
    assert optim.launch_lamb(torch.zeros(1), g, p, m, v, None,
                             weight_decay=0.01, **kw) == 1
    assert recorded[0][6] == len(g)
    with pytest.raises(ValueError, match="weight decays"):
        optim.launch_lamb(torch.zeros(1), g, p, m, v, None,
                          weight_decay=[0.0], **kw)
