"""apex_tpu_torch causal softmax (kernels/softmax and
transformer/functional/fused_softmax) against apex_tpu's on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the JAX side runs ``apex_tpu.kernels.softmax`` (the custom-VJP kernels
behind ``scaled_upper_triang_masked_softmax``) in Pallas interpret mode.
Inputs come from numpy seeds and go to both sides as the same values.

Tolerances: the forward is the TPU kernel's fp32 operation order, so
fp32 probabilities agree within 1e-6 relative (row sums in another
order) and bf16 ones within one bf16 ulp (2**-7 relative); gradients,
``scale * y * (dy - sum(dy * y))`` in fp32, within 1e-5 relative in
fp32 and one bf16 ulp in bf16, plus an absolute 1e-6 for entries near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import softmax as jax_softmax
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.kernels import softmax as port_kernels
from apex_tpu_torch.transformer.functional import (
    scaled_upper_triang_masked_softmax,
)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": dict(rtol=1e-6, atol=1e-7),
        "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
_GRAD_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
             "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["softmax"])
    yield
    reg.force_interpret(False, ["softmax"])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), want, **tol)


def _scores(seed, b, sq, sk):
    return np.random.RandomState(seed).randn(b, sq, sk).astype(np.float32) * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk", [(3, 16, 16), (2, 8, 24), (4, 1, 9)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_causal_softmax_forward_matches_jax(dtype, b, sq, sk, scale):
    x = _scores(sq * sk, b, sq, sk)
    want = jax_softmax.scaled_upper_triang_masked_softmax(
        jnp.asarray(x, _JAX[dtype]), scale)
    got = port_kernels.causal_softmax_fwd(torch.from_numpy(x).to(
        _TORCH[dtype]), scale)
    assert got.dtype == _TORCH[dtype] and got.shape == (b, sq, sk)
    _close(got, _np(want), _TOL[dtype])
    # every masked key is exactly 0
    live = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
    assert (got.float()[:, ~live] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk", [(3, 16, 16), (2, 8, 24)])
def test_causal_softmax_gradient_matches_jax_vjp(dtype, b, sq, sk):
    rng = np.random.RandomState(b * sk)
    x = _scores(sk, b, sq, sk)
    dy = rng.randn(b, sq, sk).astype(np.float32)
    y_j, vjp = jax.vjp(
        lambda t: jax_softmax.scaled_upper_triang_masked_softmax(t, 0.5),
        jnp.asarray(x, _JAX[dtype]))
    (dx_j,) = vjp(jnp.asarray(dy, _JAX[dtype]))
    xt = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    y_t = scaled_upper_triang_masked_softmax(xt, 0.5)
    y_t.backward(torch.from_numpy(dy).to(_TORCH[dtype]))
    _close(y_t, _np(y_j), _TOL[dtype])
    assert xt.grad.dtype == _TORCH[dtype]
    _close(xt.grad, _np(dx_j), _GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_bwd_plain_matches_jax_kernel(dtype):
    rng = np.random.RandomState(5)
    y = np.abs(rng.rand(12, 40).astype(np.float32))
    y /= y.sum(-1, keepdims=True)
    dy = rng.randn(12, 40).astype(np.float32)
    want = jax_softmax._bwd_rows(jnp.asarray(y, _JAX[dtype]),
                                 jnp.asarray(dy, _JAX[dtype]), 0.3,
                                 _JAX[dtype])
    got = port_kernels.softmax_bwd(torch.from_numpy(y).to(_TORCH[dtype]),
                                   torch.from_numpy(dy).to(_TORCH[dtype]),
                                   0.3)
    assert got.dtype == _TORCH[dtype]
    _close(got, _np(want), _GRAD_TOL[dtype])


def test_fp32_gradient_of_plain_version_matches_autograd():
    """The one-pass backward equals autograd through the plain forward."""
    x = torch.from_numpy(_scores(1, 2, 12, 12)).requires_grad_()
    dy = torch.randn(2, 12, 12, generator=torch.Generator().manual_seed(0))
    y = scaled_upper_triang_masked_softmax(x, 0.7)
    (dx,) = torch.autograd.grad(y, x, dy)
    x2 = x.detach().clone().requires_grad_()
    (dx_ref,) = torch.autograd.grad(
        port_kernels.causal_softmax_fwd_plain(x2, 0.7), x2, dy)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=1e-6)


def test_plain_versions_count_no_launch():
    registry.reset()
    x = torch.randn(2, 4, 4, requires_grad=True)
    scaled_upper_triang_masked_softmax(x, 1.0).sum().backward()
    launches = registry.launches()
    assert launches["causal_softmax"] == 0 and launches["softmax_bwd"] == 0


def test_four_dim_input_raises():
    with pytest.raises(ValueError, match=r"\[b, sq, sk\]"):
        scaled_upper_triang_masked_softmax(torch.zeros(2, 2, 4, 4), 1.0)


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.causal_softmax_fwd(x, 1.0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.softmax_bwd(x, torch.empty(2, 4, 4), 1.0)
