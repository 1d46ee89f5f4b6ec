"""apex_tpu_torch LayerNorm and RMSNorm (kernels/norm, ops/layer_norm,
FusedLayerNorm, MixedFusedLayerNorm, FusedRMSNorm and the functional
forms), forward and gradient, against apex_tpu's on the CPU.

The port's wrapper takes its plain PyTorch version for CPU tensors; the
JAX side runs its public function both through the jnp oracle and
through the Pallas kernel in interpret mode. Inputs come from numpy
seeds and go to both sides as the same values.

Tolerances: fp32 output within 2e-6 relative (the same fp32 operations,
summed in another order); bf16 output within one bf16 ulp (2**-7
relative: a value that sits on a rounding boundary may round either
way after an fp32 difference of one ulp). The weight's (and bias's)
gradient, a sum over rows in fp32, within 1e-5 relative. LayerNorm's
backward-dx, ``(w*dy - mean(w*dy) - xhat*mean(w*dy*xhat)) * rstd``,
cancels where the terms meet, so fp32 dx is held within 1e-5 relative
plus 1e-6 of the largest |dx| (measured: at most 2.3e-7 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import norm as jax_kernels
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu.normalization import FusedRMSNorm as JaxFusedRMSNorm
from apex_tpu.normalization import MixedFusedLayerNorm as JaxMixedLayerNorm
from apex_tpu.normalization import fused_layer_norm as jax_fused_layer_norm
from apex_tpu.normalization import (
    fused_layer_norm_affine as jax_fused_layer_norm_affine,
)
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from apex_tpu_torch.kernels import norm as port_kernels
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.normalization import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
)
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from torch_threads import one_torch_thread  # noqa: F401

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(params=["oracle", "interpret"])
def jax_path(request):
    """Run the JAX side through its oracle or its interpreted kernel."""
    reg = get_kernel_registry()
    reg.force_interpret(request.param == "interpret", ["rmsnorm",
                                                       "layernorm"])
    yield request.param
    reg.force_interpret(False, ["rmsnorm", "layernorm"])


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype):
    got = got.detach().float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_matches_jax(jax_path, in_dtype, out_dtype, affine):
    rng = np.random.RandomState(7)
    x = rng.randn(5, 3, 64).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32) if affine else None
    xj = jnp.asarray(x, _JAX[in_dtype])
    want = jax_rms_norm(xj, 64, None if w is None else jnp.asarray(w), 1e-5,
                        None if out_dtype is None else _JAX[out_dtype])
    xt = torch.from_numpy(x).to(_TORCH[in_dtype])
    got = rms_norm(xt, 64, None if w is None else torch.from_numpy(w), 1e-5,
                   None if out_dtype is None else _TORCH[out_dtype])
    expect_dtype = out_dtype or in_dtype
    assert got.dtype == _TORCH[expect_dtype]
    assert got.shape == xt.shape
    _assert_close(got, _to_np(want), expect_dtype)


@pytest.mark.parametrize("shape", [(2, 48), (3, 2, 4, 16)])
def test_rms_norm_multi_dim_normalized_shape(jax_path, shape):
    """Normalizing over several trailing dims flattens them into one."""
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    norm_shape = shape[-2:]
    w = rng.randn(*norm_shape).astype(np.float32)
    want = jax_rms_norm(jnp.asarray(x), norm_shape, jnp.asarray(w), 1e-6)
    got = rms_norm(torch.from_numpy(x), norm_shape, torch.from_numpy(w), 1e-6)
    _assert_close(got, _to_np(want), "float32")


def test_fused_rms_norm_module_matches_jax(jax_path):
    rng = np.random.RandomState(11)
    x = rng.randn(4, 2, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    mod_j = JaxFusedRMSNorm(normalized_shape=32, eps=1e-5)
    want = mod_j.apply({"params": {"weight": jnp.asarray(w)}},
                       jnp.asarray(x))
    mod_t = FusedRMSNorm(32, eps=1e-5, device="cpu")
    mod_t.load_state_dict({"weight": torch.from_numpy(w)})
    got = mod_t(torch.from_numpy(x))
    _assert_close(got, _to_np(want), "float32")
    # the layer's form: bf16 residual in, compute dtype out, equals
    # casting to fp32 before the norm and rounding after it
    xb = jnp.asarray(x, jnp.bfloat16)
    want_b = mod_j.apply({"params": {"weight": jnp.asarray(w)}},
                         xb.astype(jnp.float32)).astype(jnp.bfloat16)
    got_b = mod_t(torch.from_numpy(x).bfloat16(), out_dtype=torch.bfloat16)
    _assert_close(got_b, _to_np(want_b), "bfloat16")


def test_plain_version_counts_no_launch():
    registry.reset()
    port_kernels.rms_fwd(torch.ones(2, 8), None, 1e-5)
    port_kernels.rms_bwd_dx(torch.ones(2, 8), torch.ones(2, 8), None, 1e-5)
    assert registry.launches()["rms_norm"] == 0
    assert registry.launches()["rms_bwd"] == 0


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.rms_fwd(x, None, 1e-5)



@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dy_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_bwd_dx_plain_matches_jax_kernel(x_dtype, dy_dtype, affine):
    """The backward-dx against the interpreted Pallas kernel: dx in x's
    dtype, the row statistics recomputed from x."""
    rng = np.random.RandomState(13)
    x = rng.randn(24, 64).astype(np.float32) * 2.0
    dy = rng.randn(24, 64).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32) if affine else None
    want = jax_kernels.rms_bwd_dx(
        jnp.asarray(dy, _JAX[dy_dtype]), jnp.asarray(x, _JAX[x_dtype]),
        None if w is None else jnp.asarray(w), 1e-5, interpret=True)
    got = port_kernels.rms_bwd_dx(
        torch.from_numpy(dy).to(_TORCH[dy_dtype]),
        torch.from_numpy(x).to(_TORCH[x_dtype]),
        None if w is None else torch.from_numpy(w), 1e-5)
    assert got.dtype == _TORCH[x_dtype]
    _assert_close(got, _to_np(want), x_dtype)


def _jax_grads(x, w, dy, x_dtype, cast_to_fp32):
    """jax.grad of sum(rms_norm(x) * dy) in x and w. With
    ``cast_to_fp32`` the JAX layer's form: the bf16 residual cast to
    fp32 before the norm, the output rounded to bf16 after it."""
    def f(xj, wj):
        xin = xj.astype(jnp.float32) if cast_to_fp32 else xj
        y = jax_rms_norm(xin, 64, wj, 1e-5)
        if cast_to_fp32:
            y = y.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(x, _JAX[x_dtype]),
                                        jnp.asarray(w))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_rms_norm_gradients_match_jax_grad(jax_path, x_dtype):
    rng = np.random.RandomState(17)
    x = rng.randn(6, 5, 64).astype(np.float32) * 2.0
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    dy = rng.randn(6, 5, 64).astype(np.float32)
    dx_j, dw_j = _jax_grads(x, w, dy, x_dtype, cast_to_fp32=False)
    xt = torch.from_numpy(x).to(_TORCH[x_dtype]).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = rms_norm(xt, 64, wt, 1e-5)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == torch.float32
    _assert_close(xt.grad, _to_np(dx_j), x_dtype)
    np.testing.assert_allclose(wt.grad.numpy(), _to_np(dw_j), rtol=1e-5,
                               atol=1e-5)


def test_layer_form_gradients_match_jax_grad(jax_path):
    """The layer's form: the port's norm reads the bf16 residual and
    writes bf16, its gradient in bf16 is computed in fp32 and rounded
    once, as JAX's cast to fp32, fp32 VJP, and the cast's transpose
    back to the bf16 residual."""
    rng = np.random.RandomState(19)
    x = rng.randn(6, 5, 64).astype(np.float32) * 2.0
    w = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    dy = rng.randn(6, 5, 64).astype(np.float32)
    dx_j, dw_j = _jax_grads(x, w, dy, "bfloat16", cast_to_fp32=True)
    assert dx_j.dtype == jnp.bfloat16
    mod = FusedRMSNorm(64, eps=1e-5, device="cpu")
    mod.load_state_dict({"weight": torch.from_numpy(w)})
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    y = mod(xt, out_dtype=torch.bfloat16)
    y.float().backward(torch.from_numpy(dy))
    assert xt.grad.dtype == torch.bfloat16
    _assert_close(xt.grad, _to_np(dx_j), "bfloat16")
    np.testing.assert_allclose(mod.weight.grad.numpy(), _to_np(dw_j),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- LayerNorm

def _ln_params(rng, h, affine):
    if not affine:
        return None, None
    return ((1.0 + 0.1 * rng.randn(h)).astype(np.float32),
            (0.1 * rng.randn(h)).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_ln_fwd_plain_matches_jax_kernel(in_dtype, out_dtype, affine):
    """The forward against the interpreted Pallas kernel (rounded to the
    input's dtype, then to the output's)."""
    rng = np.random.RandomState(23)
    x = (rng.randn(24, 64) * 3.0 + 1.5).astype(np.float32)
    w, b = _ln_params(rng, 64, affine)
    xj = jnp.asarray(x, _JAX[in_dtype])
    want = jax_kernels.ln_fwd(xj, _j(w), _j(b), 1e-5, interpret=True)
    if out_dtype is not None:
        want = want.astype(_JAX[out_dtype])
    got = port_kernels.ln_fwd(torch.from_numpy(x).to(_TORCH[in_dtype]),
                              _t(w), _t(b), 1e-5,
                              None if out_dtype is None else _TORCH[out_dtype])
    expect = out_dtype or in_dtype
    assert got.dtype == _TORCH[expect] and got.shape == x.shape
    _assert_close(got, _to_np(want), expect)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dy_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_ln_bwd_dx_plain_matches_jax_kernel(x_dtype, dy_dtype, affine):
    """The backward-dx against the interpreted Pallas kernel: dx in x's
    dtype, the row statistics recomputed from x."""
    rng = np.random.RandomState(29)
    x = (rng.randn(24, 64) * 2.0 - 0.5).astype(np.float32)
    dy = rng.randn(24, 64).astype(np.float32)
    w, _ = _ln_params(rng, 64, affine)
    want = _to_np(jax_kernels.ln_bwd_dx(
        jnp.asarray(dy, _JAX[dy_dtype]), jnp.asarray(x, _JAX[x_dtype]),
        _j(w), 1e-5, interpret=True))
    got = port_kernels.ln_bwd_dx(torch.from_numpy(dy).to(_TORCH[dy_dtype]),
                                 torch.from_numpy(x).to(_TORCH[x_dtype]),
                                 _t(w), 1e-5)
    assert got.dtype == _TORCH[x_dtype]
    if x_dtype == "bfloat16":
        _assert_close(got, want, x_dtype)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(jax_path, in_dtype, out_dtype, affine):
    rng = np.random.RandomState(31)
    x = (rng.randn(5, 3, 64) * 3.0 + 2.0).astype(np.float32)
    w, b = _ln_params(rng, 64, affine)
    want = jax_layer_norm(jnp.asarray(x, _JAX[in_dtype]), 64, _j(w), _j(b),
                          1e-5, None if out_dtype is None else _JAX[out_dtype])
    got = layer_norm(torch.from_numpy(x).to(_TORCH[in_dtype]), 64, _t(w),
                     _t(b), 1e-5,
                     None if out_dtype is None else _TORCH[out_dtype])
    expect = out_dtype or in_dtype
    assert got.dtype == _TORCH[expect] and got.shape == x.shape
    _assert_close(got, _to_np(want), expect)


def _jax_ln_grads(x, w, b, dy, x_dtype, cast_to_fp32):
    """jax.grad of sum(layer_norm(x) * dy) in x, w and b (w, b may be
    None: then only x). With ``cast_to_fp32`` the JAX layer's form: the
    bf16 residual cast to fp32 before the norm, the output rounded to
    bf16 after it."""
    def f(xj, *wb):
        xin = xj.astype(jnp.float32) if cast_to_fp32 else xj
        y = jax_layer_norm(xin, 64, *(wb or (None, None)), 1e-5)
        if cast_to_fp32:
            y = y.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))
    args = [jnp.asarray(x, _JAX[x_dtype])]
    if w is not None:
        args += [jnp.asarray(w), jnp.asarray(b)]
    return jax.grad(f, argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_gradients_match_jax_grad(jax_path, x_dtype, affine):
    """dx, dw and db through the autograd Function against jax.grad
    through the custom VJP."""
    rng = np.random.RandomState(37)
    x = (rng.randn(6, 5, 64) * 2.0 + 1.0).astype(np.float32)
    w, b = _ln_params(rng, 64, affine)
    dy = rng.randn(6, 5, 64).astype(np.float32)
    grads_j = _jax_ln_grads(x, w, b, dy, x_dtype, cast_to_fp32=False)
    xt = torch.from_numpy(x).to(_TORCH[x_dtype]).requires_grad_()
    wt = None if w is None else torch.from_numpy(w).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    y = layer_norm(xt, 64, wt, bt, 1e-5)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert xt.grad.dtype == xt.dtype
    dx_j = _to_np(grads_j[0])
    if x_dtype == "bfloat16":
        _assert_close(xt.grad, dx_j, x_dtype)
    else:
        np.testing.assert_allclose(xt.grad.numpy(), dx_j, rtol=1e-5,
                                   atol=1e-6 * np.abs(dx_j).max())
    if affine:
        for t, g in ((wt, grads_j[1]), (bt, grads_j[2])):
            assert t.grad.dtype == torch.float32
            np.testing.assert_allclose(t.grad.numpy(), _to_np(g), rtol=1e-5,
                                       atol=1e-5)


def test_layernorm_layer_form_gradients_match_jax_grad(jax_path):
    """The layer's form: the port's LayerNorm reads the bf16 residual and
    writes bf16, as JAX's cast to fp32, fp32 norm, rounding to bf16; its
    dx in bf16 is computed in fp32 and rounded once."""
    rng = np.random.RandomState(41)
    x = (rng.randn(6, 5, 64) * 2.0).astype(np.float32)
    w, b = _ln_params(rng, 64, True)
    dy = rng.randn(6, 5, 64).astype(np.float32)
    dx_j, dw_j, db_j = _jax_ln_grads(x, w, b, dy, "bfloat16",
                                     cast_to_fp32=True)
    assert dx_j.dtype == jnp.bfloat16
    mod = FusedLayerNorm(64, eps=1e-5, device="cpu")
    mod.load_state_dict({"weight": torch.from_numpy(w),
                         "bias": torch.from_numpy(b)})
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    y = mod(xt, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y.float().backward(torch.from_numpy(dy))
    _assert_close(xt.grad, _to_np(dx_j), "bfloat16")
    np.testing.assert_allclose(mod.weight.grad.numpy(), _to_np(dw_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.bias.grad.numpy(), _to_np(db_j),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 48), (3, 2, 4, 16)])
def test_layer_norm_multi_dim_normalized_shape(jax_path, shape):
    """Normalizing over several trailing dims flattens them into one."""
    rng = np.random.RandomState(43)
    x = rng.randn(*shape).astype(np.float32)
    norm_shape = shape[-2:]
    w = rng.randn(*norm_shape).astype(np.float32)
    b = rng.randn(*norm_shape).astype(np.float32)
    want = jax_layer_norm(jnp.asarray(x), norm_shape, jnp.asarray(w),
                          jnp.asarray(b), 1e-6)
    got = layer_norm(torch.from_numpy(x), norm_shape, torch.from_numpy(w),
                     torch.from_numpy(b), 1e-6)
    _assert_close(got, _to_np(want), "float32")


def test_layer_norm_modules_and_functions_match_jax(jax_path):
    """FusedLayerNorm (with and without affine), MixedFusedLayerNorm
    (output in the parameters' fp32) and the functional forms."""
    rng = np.random.RandomState(47)
    x = (rng.randn(4, 2, 32) * 2.0).astype(np.float32)
    w, b = _ln_params(rng, 32, True)
    params = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    xb = jnp.asarray(x, jnp.bfloat16)
    mod = FusedLayerNorm(32, device="cpu")
    mod.load_state_dict({"weight": torch.from_numpy(w),
                         "bias": torch.from_numpy(b)})
    _assert_close(mod(torch.from_numpy(x)),
                  _to_np(JaxFusedLayerNorm(32).apply(params, jnp.asarray(x))),
                  "float32")
    bare = FusedLayerNorm(32, elementwise_affine=False, device="cpu")
    assert list(bare.parameters()) == []
    _assert_close(bare(torch.from_numpy(x)), _to_np(
        JaxFusedLayerNorm(32, elementwise_affine=False).apply(
            {}, jnp.asarray(x))), "float32")
    mixed = MixedFusedLayerNorm(32, device="cpu")
    mixed.load_state_dict(mod.state_dict())
    got = mixed(torch.from_numpy(x).bfloat16())
    want = JaxMixedLayerNorm(32).apply(params, xb)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _assert_close(got, _to_np(want), "bfloat16")
    _assert_close(fused_layer_norm_affine(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 32),
        _to_np(jax_fused_layer_norm_affine(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), 32)), "float32")
    _assert_close(fused_layer_norm(torch.from_numpy(x), 32),
                  _to_np(jax_fused_layer_norm(jnp.asarray(x), 32)),
                  "float32")


def test_layer_norm_plain_versions_count_no_launch():
    registry.reset()
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    layer_norm(x, 8, w, torch.zeros(8, requires_grad=True)).sum().backward()
    assert registry.launches()["layer_norm"] == 0
    assert registry.launches()["ln_bwd"] == 0


def test_ln_wrappers_refuse_a_meta_tensor():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.ln_fwd(x, None, None, 1e-5)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.ln_bwd_dx(x, torch.empty(2, 8), None, 1e-5)
