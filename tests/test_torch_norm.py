"""apex_tpu_torch RMSNorm (kernels/norm, ops/layer_norm, FusedRMSNorm)
against apex_tpu's on the CPU.

The port's wrapper takes its plain PyTorch version for CPU tensors; the
JAX side runs its public function both through the jnp oracle and
through the Pallas kernel in interpret mode. Inputs come from numpy
seeds and go to both sides as the same values.

Tolerances: fp32 output within 2e-6 relative (the same fp32 operations,
summed in another order); bf16 output within one bf16 ulp (2**-7
relative: a value that sits on a rounding boundary may round either
way after an fp32 difference of one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.normalization import FusedRMSNorm as JaxFusedRMSNorm
from apex_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from apex_tpu_torch.kernels import norm as port_kernels
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops.layer_norm import rms_norm

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(params=["oracle", "interpret"])
def jax_path(request):
    """Run the JAX side through its oracle or its interpreted kernel."""
    reg = get_kernel_registry()
    reg.force_interpret(request.param == "interpret", ["rmsnorm"])
    yield request.param
    reg.force_interpret(False, ["rmsnorm"])


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
    assert registry.launches()["rms_norm"] == 0


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.rms_fwd(x, None, 1e-5)

