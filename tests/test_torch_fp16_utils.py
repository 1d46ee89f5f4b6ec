"""apex_tpu_torch.fp16_utils (the loss scalers, fp16util's conversions,
FP16_Optimizer) and the deprecated contrib optimizers against apex_tpu's
on the CPU, where the kernels take their plain versions.

The models are a two-layer GPT at small widths: the port's ``GPTModel``
and the JAX model's parameter tree (traced abstractly, nothing
compiled), matched by name (the flax ``layer_<i>`` scope is the port's
``layers.<i>``). FP16_Optimizer's steps take the same seeded bf16
gradients on both sides (a synthetic scaled loss's), so the optimizer is
held without the model's forward.

Tolerances: the loss scalers are host arithmetic, compared exactly. The
conversions are casts and copies, compared exactly. FP16_Optimizer's
unscale (``g.astype(f32) * (1 / scale)``) and its FusedAdam step are the
same fp32 operations in the same order, elementwise, so master
gradients, masters, moments, parameters and step counts are compared bit
for bit (JAX's steps run op by op, step counts at most 2, where its
eager bias corrections equal the traced ones). ``clip_master_grads``'s
norm is a sum of the model's ~140 k squares in another order (torch's
against XLA's), held within 1e-5 relative (1.04e-6 measured; the
ordering bound of such a sum is far above either).
"""

import copy
import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fp16_utils as jax_fp16
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import fp16_utils
from apex_tpu_torch.contrib import optimizers as contrib
from apex_tpu_torch.fp16_utils import FP16_Optimizer
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.models.params import (
    from_jax_params,
    load_jax_optimizer_state,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
from torch_threads import one_torch_thread  # noqa: F401

GPT_KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
              vocab_size=256, max_position_embeddings=128,
              use_flash_attention=False)
_LAYER = re.compile(r"^(transformer\.)?layer_(\d+)\.")
TDT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _port_name(path):
    return _LAYER.sub(r"\1layers.\2.", ".".join(
        str(getattr(k, "key", k)) for k in path))


def _named(tree):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.__setitem__(_port_name(path), leaf), tree)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX GPT's fp32 parameter tree (numpy leaves), drawn from a
    numpy seed: ~N(0, 0.02), norm weights 1 and biases 0."""
    jm = JaxGPTModel(JaxConfig(**GPT_KW))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.RandomState(7)

    def draw(path, leaf):
        name = _port_name(path)
        if "norm" in name:
            fill = np.zeros if name.endswith("bias") else np.ones
            return fill(leaf.shape, np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _model():
    cfg = TransformerConfig(**GPT_KW)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(_jax_params(), cfg))
    return model


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_host(g), _host(w),
                                      err_msg=f"{what} {k}")


# ------------------------------------------------------- the scalers

FLAGS = [False, False, True, False, False, False, True, True, True, True,
         True, False, False, False, False, False]


@pytest.mark.parametrize("kw", [dict(), dict(scale_window=2),
                                dict(init_scale=4.0, scale_factor=2.0,
                                     scale_window=3),
                                dict(init_scale=2.0 ** 10, scale_factor=4.0,
                                     scale_window=1)])
def test_dynamic_loss_scaler_follows_jax(kw):
    """The scale, cur_iter and last_overflow_iter after each flag as
    JAX's: backoff floored at 1, growth when (cur_iter -
    last_overflow_iter) % scale_window == 0, cur_iter advancing on every
    update; has_overflow reads a planted inf or NaN."""
    port, ref = (fp16_utils.DynamicLossScaler(**kw),
                 jax_fp16.DynamicLossScaler(**kw))
    for k, flag in enumerate(FLAGS):
        port.update_scale(flag)
        ref.update_scale(flag)
        assert (port.loss_scale, port.cur_iter, port.last_overflow_iter) == (
            ref.loss_scale, ref.cur_iter, ref.last_overflow_iter), k
    if kw.get("init_scale") == 4.0:
        assert min(s for s in [port.loss_scale]) >= 1
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")]).bfloat16()]
    assert port.has_overflow(grads) and ref.has_overflow(
        [jnp.ones(3), jnp.asarray([1.0, np.inf], jnp.bfloat16)])
    grads[1] = torch.tensor([float("nan")])
    assert port.has_overflow(grads) and not port.has_overflow(grads[:1])


def test_backoff_is_floored_at_one_as_jax():
    port = fp16_utils.DynamicLossScaler(init_scale=4.0, scale_window=100)
    ref = jax_fp16.DynamicLossScaler(init_scale=4.0, scale_window=100)
    for _ in range(5):
        port.update_scale(True)
        ref.update_scale(True)
        assert port.loss_scale == ref.loss_scale
    assert port.loss_scale == 1


def test_static_loss_scaler_scales_as_jax():
    port, ref = fp16_utils.LossScaler(128.0), jax_fp16.LossScaler(128.0)
    port.update_scale(True)
    assert port.loss_scale == ref.loss_scale == 128.0
    assert port.has_overflow([torch.tensor([float("inf")])]) is False
    g = [torch.tensor([0.5, -2.0])]
    _equal(port.scale_gradient(g), ref.scale_gradient([jnp.asarray(
        [0.5, -2.0])]), "scaled gradients")
    w = torch.tensor(3.0, requires_grad=True)
    scaled = port.backward(w * w)
    assert scaled.item() == float(ref.backward(jnp.float32(9.0)))
    assert w.grad.item() == 6.0 * 128.0


# ------------------------------------------------------ the conversions

def test_network_to_half_keeps_the_norms_fp32_as_jax():
    """network_to_half (bf16 by default) and convert_network cast the
    parameters JAX's cast, by name: the norm layers' fp32, the rest bf16;
    BN_convert_float brings the norms of an all-bf16 model back to fp32.
    The Parameter objects are kept (in place)."""
    want = {n: TDT[jnp.dtype(v.dtype)] for n, v in _named(
        jax_fp16.network_to_half(jax.tree.map(jnp.asarray,
                                              _jax_params()))).items()}
    model = _model()
    before = list(model.parameters())
    assert fp16_utils.network_to_half(model) is model
    got = {n: p.dtype for n, p in model.named_parameters()}
    assert got == want
    assert 0 < sum(d == torch.float32 for d in got.values()) < len(got)
    assert all(a is b for a, b in zip(before, model.parameters()))
    other = fp16_utils.convert_network(_model(), torch.bfloat16)
    assert {n: p.dtype for n, p in other.named_parameters()} == want
    all_half = _model()
    for p in all_half.parameters():
        p.data = p.data.bfloat16()
    jax_half = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                            _jax_params())
    want_bn = {n: TDT[jnp.dtype(v.dtype)] for n, v in _named(
        jax_fp16.BN_convert_float(jax_half)).items()}
    fp16_utils.BN_convert_float(all_half)
    assert {n: p.dtype for n, p in all_half.named_parameters()} == want_bn


@pytest.mark.parametrize("flat", [False, True])
def test_param_lists_round_trip_as_jax(flat):
    """prep_param_lists' fp32 masters (never aliasing a parameter; flat:
    one vector in parameter order), model_grads_to_master_grads and
    master_params_to_model_params as JAX's on the same ordered lists; a
    master changed and written back reaches its parameter rounded to its
    dtype."""
    model = fp16_utils.network_to_half(_model())
    params, masters = fp16_utils.prep_param_lists(model, flat_master=flat)
    assert params == list(model.parameters())
    jleaves = [jnp.array(p.detach().float().numpy()).astype(
        jnp.bfloat16 if p.dtype == torch.bfloat16 else jnp.float32)
        for p in params]
    if flat:
        want = np.concatenate([_host(p).ravel() for p in params])
        _equal(masters, [want], "flat master")
    else:
        _equal(masters, params, "masters")
        assert all(m.data_ptr() != p.data_ptr()
                   for m, p in zip(masters, params))
    assert all(m.dtype == torch.float32 and m.requires_grad for m in masters)
    rng = np.random.RandomState(3)
    grads = [rng.randn(*p.shape).astype(np.float32) for p in params]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g).to(p.dtype)
    got = fp16_utils.model_grads_to_master_grads(params, masters, flat)
    want = jax_fp16.model_grads_to_master_grads(
        [jnp.asarray(g).astype(jl.dtype) for g, jl in zip(grads, jleaves)],
        None, flat)
    _equal(got, want, "master grads")
    with torch.no_grad():
        for m in masters:
            m.add_(0.001)
    fp16_utils.master_params_to_model_params(params, masters, flat)
    want = jax_fp16.master_params_to_model_params(
        jleaves, [jnp.asarray(_host(m)) for m in masters], flat)
    _equal(params, want, "parameters written back")
    assert [p.dtype for p in params] == [TDT[jnp.dtype(j.dtype)]
                                         for j in want]


def test_to_python_float():
    assert fp16_utils.to_python_float(torch.tensor([2.5])) == 2.5
    assert fp16_utils.to_python_float(3) == 3.0


# ------------------------------------------------------ FP16_Optimizer

def _master_of(fopt, p):
    return next(m for q, m in zip(fopt.model_params, fopt.masters) if q is p)


def _half_pair(kw, **opt_kw):
    """(the port's bf16 model, its FP16_Optimizer over FusedAdam, the JAX
    FP16_Optimizer, its state, the JAX half tree)."""
    model = fp16_utils.network_to_half(_model())
    fopt = FP16_Optimizer(FusedAdam(model.parameters(), lr=1e-3, **opt_kw),
                          dynamic_loss_scale=True, dynamic_loss_args=kw)
    jopt = jax_fp16.FP16_Optimizer(JaxFusedAdam(lr=1e-3, **opt_kw),
                                   dynamic_loss_scale=True,
                                   dynamic_loss_args=kw)
    jparams = jax_fp16.network_to_half(jax.tree.map(jnp.asarray,
                                                    _jax_params()))
    return model, fopt, jopt, jopt.init(jparams), jparams


def _grads(model, seed, scale, inf=False):
    """Seeded gradients of a scaled loss on both sides: {name: numpy
    fp32}, set as each parameter's .grad in its dtype; an inf planted in
    one where ``inf``."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, p in model.named_parameters():
        g = (rng.randn(*p.shape) * 1e-3 * scale).astype(np.float32)
        out[n] = g
    if inf:
        name = sorted(out)[3]
        out[name].reshape(-1)[5] = np.inf
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(out[n]).to(p.dtype)
    return out


def _jax_grads(grads, like):
    named = _named(like)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(grads[_port_name(path)]).astype(
            named[_port_name(path)].dtype), like)


def _hold(model, fopt, jparams, jstate, what):
    """Parameters, masters, moments and the step count as JAX's, by name,
    bit for bit."""
    named = dict(model.named_parameters())
    jp, jm = _named(jparams), _named(jstate["fp32_master"])
    master_of = dict(zip(map(id, fopt.model_params), fopt.masters))
    for n, p in named.items():
        assert p.dtype == TDT[jnp.dtype(jp[n].dtype)], n
        _equal([p, master_of[id(p)]], [jp[n], jm[n]], f"{what}: {n}")
        for key in ("exp_avg", "exp_avg_sq"):
            _equal([fopt.state[master_of[id(p)]][key]],
                   [_named(jstate[key])[n]], f"{what}: {key} of {n}")
    assert int(fopt.param_groups[0]["step"]) == int(jstate["step"]), what


def test_fp16_optimizer_three_steps_match_jax_bit_for_bit():
    """Three steps over FusedAdam (masters fp32, never aliasing a
    parameter): a clean one, one with an inf planted (skipped bit for
    bit: the flag on the device, no host read in step), a clean one; the
    parameters written from the masters; update_master_grads' master
    gradients and overflow as JAX's."""
    kw = dict(init_scale=2.0 ** 10, scale_window=1000)
    model, fopt, jopt, js, jp = _half_pair(kw)
    assert all(m.data_ptr() != p.data_ptr()
               for m, p in zip(fopt.masters, fopt.model_params))
    for k, inf in enumerate((False, True, False)):
        grads = _grads(model, 20 + k, fopt.loss_scale, inf)
        jg = _jax_grads(grads, jp)
        got = fopt.update_master_grads()
        want = jopt.update_master_grads(jg)
        assert fopt.overflow is jopt.overflow is inf
        master_grad = dict(zip(map(id, fopt.model_params), got))
        wm = _named(want)
        for n, p in model.named_parameters():
            _equal([master_grad[id(p)]], [wm[n]], f"master grad {n}")
        assert fopt.loss_scale == jopt.loss_scale
        before = [p.detach().clone() for p in model.parameters()]
        fopt.step()
        jp, js = jopt.step(jg, js, jp)
        _hold(model, fopt, jp, js, f"step {k}")
        if inf:
            _equal(list(model.parameters()), before, "skipped step")
        fopt.zero_grad()
    assert int(fopt.param_groups[0]["step"]) == 2


def test_fp16_optimizer_step_unscales_by_the_scale_update_master_grads_left():
    """JAX's quirk, reproduced: update_master_grads updates the scale
    (here it grows it, and on an overflow halves it), and step() then
    unscales the same gradients by that new scale."""
    kw = dict(init_scale=2.0 ** 8, scale_window=1)
    model, fopt, jopt, js, jp = _half_pair(kw)
    grads = _grads(model, 30, fopt.loss_scale)
    jg = _jax_grads(grads, jp)
    fopt.update_master_grads()
    jopt.update_master_grads(jg)
    assert fopt.loss_scale == jopt.loss_scale == 2.0 ** 9  # grown
    fopt.step()
    jp, js = jopt.step(jg, js, jp)
    _hold(model, fopt, jp, js, "step after growth")
    # the masters' gradients are the gradients unscaled by 2^-9, not 2^-8
    name, p = next((n, q) for n, q in model.named_parameters()
                   if q.dtype == torch.bfloat16)
    master = _master_of(fopt, p)
    want = torch.from_numpy(grads[name]).bfloat16().float() * (2.0 ** -9)
    assert torch.equal(master.grad, want)


def test_fp16_optimizer_clip_master_grads_as_jax():
    model, fopt, jopt, js, jp = _half_pair(dict(init_scale=4.0))
    grads = _grads(model, 40, 4.0 * 1e4)
    fopt.update_master_grads()
    want, want_total = jopt.clip_master_grads(
        jopt.update_master_grads(_jax_grads(grads, jp)), 0.5)
    total = fopt.clip_master_grads(0.5)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    wn = _named(want)
    for n, p in model.named_parameters():
        m = _master_of(fopt, p)
        np.testing.assert_allclose(_host(m.grad), _host(wn[n]), rtol=1e-5,
                                   atol=1e-12, err_msg=n)


def test_fp16_optimizer_state_dict_round_trip():
    """state_dict holds JAX's scaler entries (as JAX's state_dict gives
    them), the inner state and the masters; a fresh FP16_Optimizer loaded
    from it takes the same next step, bit for bit."""
    kw = dict(init_scale=2.0 ** 10, scale_window=2)
    model, fopt, jopt, js, jp = _half_pair(kw)
    for k, inf in enumerate((False, True)):
        jg = _jax_grads(_grads(model, 50 + k, fopt.loss_scale, inf), jp)
        fopt.update_master_grads()
        jopt.update_master_grads(jg)
        fopt.step()
        jp, js = jopt.step(jg, js, jp)
        fopt.zero_grad()
    sd = copy.deepcopy(fopt.state_dict())
    assert {k: sd[k] for k in jopt.state_dict()} == jopt.state_dict()
    other = fp16_utils.network_to_half(_model())
    with torch.no_grad():
        for a, b in zip(other.parameters(), model.parameters()):
            a.copy_(b)
    fresh = FP16_Optimizer(FusedAdam(other.parameters(), lr=1e-3),
                           dynamic_loss_scale=True, dynamic_loss_args=kw)
    fresh.load_state_dict(sd)
    assert fresh.state_dict().keys() == sd.keys()
    assert (fresh.loss_scale, fresh.overflow) == (fopt.loss_scale,
                                                  fopt.overflow)
    for opt, m in ((fopt, model), (fresh, other)):
        _grads(m, 60, opt.loss_scale)
        opt.step()
    _equal(list(other.parameters()), list(model.parameters()), "params")
    _equal(fresh.masters, fopt.masters, "masters")


def test_fp16_optimizer_refuses_what_it_cannot_wrap():
    model = fp16_utils.network_to_half(_model())
    with pytest.raises(TypeError, match="fused optimizers"):
        FP16_Optimizer(torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(TypeError, match="masters"):
        FP16_Optimizer(FusedAdam(model.parameters(), master_weights=True))


def test_load_jax_fp16_optimizer_state_continues_the_jax_trajectory():
    """The JAX FP16_Optimizer's state after a step (its fp32_master and
    the inner FusedAdam's moments and step, in JAX's sorted leaf order)
    carried into the port's: the next step equals JAX's, bit for bit."""
    kw = dict(init_scale=2.0 ** 10, scale_window=1000)
    model, fopt, jopt, js, jp = _half_pair(kw)
    for k in range(1):  # step counts <= 2: JAX's eager power is exact
        jg = _jax_grads(_grads(model, 70 + k, jopt.loss_scale), jp)
        jp, js = jopt.step(jg, js, jp)
    with torch.no_grad():
        named = _named(jp)
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(named[n], np.float32)))
    fresh = FP16_Optimizer(FusedAdam(model.parameters(), lr=1e-3),
                           dynamic_loss_scale=True, dynamic_loss_args=kw)
    load_jax_optimizer_state(fresh, model, jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.ndim else np.asarray(a),
        js))
    jg = _jax_grads(_grads(model, 72, jopt.loss_scale), jp)
    fresh.step()
    jp, js = jopt.step(jg, js, jp)
    _hold(model, fresh, jp, js, "the carried step")


# ------------------------------------------- the deprecated contrib set

@pytest.mark.parametrize("name", ["FusedAdam", "FusedLAMB", "FusedSGD",
                                  "FP16_Optimizer"])
def test_deprecated_aliases_warn_and_step_as_their_counterparts(name):
    """Each of contrib's deprecated optimizers warns with a
    DeprecationWarning and takes the same two steps as its counterpart,
    bit for bit (FusedAdam dropping use_mt and amp_scale_adjustment)."""
    counterpart = {"FusedAdam": FusedAdam, "FusedLAMB": FusedLAMB,
                   "FusedSGD": FusedSGD}

    def build(alias):
        model = _model()
        if name == "FP16_Optimizer":
            fp16_utils.network_to_half(model)
            inner = FusedAdam(model.parameters(), lr=1e-3)
            cls = contrib.FP16_Optimizer if alias else FP16_Optimizer
            return model, cls(inner, static_loss_scale=8.0)
        kw = dict(lr=0.01)
        if name == "FusedSGD":
            kw["momentum"] = 0.9
        if alias and name == "FusedAdam":
            kw.update(use_mt=True, amp_scale_adjustment=1.0)
        cls = getattr(contrib, name) if alias else counterpart[name]
        return model, cls(model.parameters(), **kw)

    with pytest.warns(DeprecationWarning, match="deprecated"):
        old_model, old = build(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        new_model, new = build(False)
    assert isinstance(old, type(new))
    for seed in (80, 81):
        for model, opt in ((old_model, old), (new_model, new)):
            _grads(model, seed, 8.0)
            opt.step()
            opt.zero_grad()
    _equal(list(old_model.parameters()), list(new_model.parameters()),
           "parameters")
