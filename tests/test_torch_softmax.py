"""apex_tpu_torch scaled, scaled-masked and causal softmax
(kernels/softmax and transformer/functional/fused_softmax, with
FusedScaleMaskSoftmax) against apex_tpu's on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the JAX side runs ``apex_tpu.kernels.softmax`` (the custom-VJP kernels
behind ``scaled_softmax``, ``scaled_masked_softmax`` and
``scaled_upper_triang_masked_softmax``) in Pallas interpret mode.
Inputs come from numpy seeds and go to both sides as the same values.
A row whose every key is masked is NaN on both sides (0 / 0, the JAX
oracle's value, which the port reproduces). Measured for the masked
forms: fp32 probabilities and gradients within 4.5e-8 absolute of
JAX's, bf16 ones equal.

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
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional import fused_softmax as jax_functional
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.kernels import softmax as port_kernels
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax,
    GenericFusedScaleMaskSoftmax,
    scaled_masked_softmax,
    scaled_softmax,
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


# ------------------------------------------------- scaled and masked softmax

def _mask(seed, shape, nan_row=False):
    """A bool mask (True = masked) with about a third of the keys masked,
    key 0 of every row live; with ``nan_row`` one row entirely masked."""
    m = np.random.RandomState(seed).rand(*shape) < 0.35
    m[..., 0] = False
    if nan_row:
        m[(0,) * (m.ndim - 2) + (1,)] = True
    return m


def _scores4(seed, b, n, sq, sk):
    return (np.random.RandomState(seed).randn(b, n, sq, sk).astype(np.float32)
            * 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 8, 24), (5, 17), (3, 1, 9)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_scaled_softmax_forward_matches_jax(dtype, shape, scale):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32) * 4
    want = jax_softmax.scaled_softmax(jnp.asarray(x, _JAX[dtype]), scale)
    got = port_kernels.scaled_softmax_fwd(
        torch.from_numpy(x).to(_TORCH[dtype]), scale)
    assert got.dtype == _TORCH[dtype] and got.shape == x.shape
    _close(got, _np(want), _TOL[dtype])


# (x shape, mask shape): a [b, 1, sq, sk] mask broadcast over the heads
# (BERT's), a full one, one [sq, sk] for every (b, n) (the window band),
# a query-side padding mask [b, 1, sq, 1] broadcast over heads and keys
MASK_CASES = [((2, 3, 8, 24), (2, 1, 8, 24)), ((2, 3, 8, 24), (2, 3, 8, 24)),
              ((2, 2, 16, 16), (16, 16)), ((2, 3, 8, 24), (2, 1, 8, 1))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xshape,mshape", MASK_CASES)
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_scaled_masked_softmax_forward_matches_jax(dtype, xshape, mshape,
                                                   scale):
    x = _scores4(sum(xshape), *xshape)
    m = _mask(sum(mshape), mshape, nan_row=True)
    want = _np(jax_functional.scaled_masked_softmax(
        jnp.asarray(x, _JAX[dtype]), jnp.asarray(m), scale))
    got = port_kernels.scaled_masked_softmax_fwd(
        torch.from_numpy(x).to(_TORCH[dtype]), torch.from_numpy(m), scale)
    assert got.dtype == _TORCH[dtype] and got.shape == x.shape
    full = np.broadcast_to(m, x.shape)
    nan_rows = full.all(-1)
    assert nan_rows.any() and np.isnan(want[nan_rows]).all()
    assert torch.isnan(got.float()[torch.from_numpy(nan_rows)]).all()
    live = ~nan_rows
    _close(got.float()[torch.from_numpy(live)], want[live], _TOL[dtype])
    # masked keys of the other rows are exactly 0
    assert (got.float().numpy()[full & live[..., None]] == 0).all()


@pytest.mark.parametrize("mshape,transpose", [
    ((2, 1, 8, 24), False), ((2, 1, 8, 1), False), ((8, 1), False),
    ((24,), False), ((1,), False), ((2, 3, 24, 8), True),
    ((2, 1, 24, 8), True)])
def test_mask_view_gives_the_flags_the_kernel_reads(mshape, transpose):
    """The kernel reads flag j of row (bi, ni, i) at bi*s0 + ni*s1 + i*s2
    + j from the view's first byte, with s0..s2 the view's strides: that
    read, made here with as_strided over the same storage, must give the
    mask broadcast to the scores' shape (and stay inside the storage)."""
    shape = (2, 3, 8, 24)
    m = torch.from_numpy(_mask(sum(mshape), mshape))
    if transpose:  # keys strided in memory
        m = m.transpose(-1, -2)
    view = port_kernels._mask_view("test", m, shape)
    assert view.shape == shape and view.element_size() == 1
    read = torch.as_strided(view, shape, view.stride()[:3] + (1,),
                            view.storage_offset())
    assert torch.equal(read != 0, m.expand(shape))


def test_masked_softmax_takes_uint8_and_float_masks():
    x = _scores4(3, 2, 2, 4, 8)
    m = _mask(4, (2, 1, 4, 8))
    want = port_kernels.scaled_masked_softmax_fwd(torch.from_numpy(x),
                                                  torch.from_numpy(m), 0.5)
    for mm in (m.astype(np.uint8), m.astype(np.float32)):
        got = port_kernels.scaled_masked_softmax_fwd(
            torch.from_numpy(x), torch.from_numpy(mm), 0.5)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_scaled_masked_softmax_gradient_matches_jax_vjp(dtype, masked):
    """Through the autograd Functions against jax.vjp through the custom
    VJPs (partial masks: every row keeps a key)."""
    x = _scores4(7, 2, 3, 8, 24)
    m = _mask(8, (2, 1, 8, 24)) if masked else None
    dy = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    jm = None if m is None else jnp.asarray(m)
    y_j, vjp = jax.vjp(
        lambda t: jax_functional.scaled_masked_softmax(t, jm, 0.5),
        jnp.asarray(x, _JAX[dtype]))
    (dx_j,) = vjp(jnp.asarray(dy, _JAX[dtype]))
    xt = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    y_t = scaled_masked_softmax(xt, None if m is None else torch.from_numpy(m),
                                0.5)
    y_t.backward(torch.from_numpy(dy).to(_TORCH[dtype]))
    _close(y_t, _np(y_j), _TOL[dtype])
    assert xt.grad.dtype == _TORCH[dtype]
    _close(xt.grad, _np(dx_j), _GRAD_TOL[dtype])
    if m is not None:  # masked keys get no gradient
        assert (xt.grad.float().numpy()[np.broadcast_to(m, x.shape)]
                == 0).all()


def test_scaled_softmax_gradient_matches_autograd_of_plain_version():
    x = torch.from_numpy(_scores4(11, 2, 2, 6, 10)).requires_grad_()
    dy = torch.randn(2, 2, 6, 10, generator=torch.Generator().manual_seed(1))
    (dx,) = torch.autograd.grad(scaled_softmax(x, 0.3), x, dy)
    x2 = x.detach().clone().requires_grad_()
    (dx_ref,) = torch.autograd.grad(
        port_kernels.scaled_softmax_fwd_plain(x2, 0.3), x2, dy)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=1e-6)


def _mask_funcs():
    return ((lambda t, m: jnp.where(m, -10000.0, t)),
            (lambda t, m: t.masked_fill(m, -10000.0)))


@pytest.mark.parametrize("kind", ["causal", "padding", "padding-nomask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fusion", [True, False])
def test_fused_scale_mask_softmax_matches_jax(kind, dtype, fusion):
    """The dispatching front end: the same availability decision and the
    same probabilities as JAX's, fused or not."""
    jf, tf = _mask_funcs()
    bf16 = dtype == "bfloat16"
    jmt = JaxMaskType.causal if kind == "causal" else JaxMaskType.padding
    tmt = AttnMaskType.causal if kind == "causal" else AttnMaskType.padding
    args = (False, bf16, fusion, None, True, 0.5)
    jax_sm = jax_functional.FusedScaleMaskSoftmax(
        args[0], args[1], jmt, args[2], jf, args[4], args[5])
    port_sm = FusedScaleMaskSoftmax(args[0], args[1], tmt, args[2], tf,
                                    args[4], args[5])
    x = _scores4(13, 2, 4, 32, 32)
    m = None if kind != "padding" else _mask(14, (2, 1, 32, 32))
    want = jax_sm(jnp.asarray(x, _JAX[dtype]),
                  None if m is None else jnp.asarray(m))
    got = port_sm(torch.from_numpy(x).to(_TORCH[dtype]),
                  None if m is None else torch.from_numpy(m))
    assert (port_sm.is_kernel_available(m, 2, 4, 32, 32)
            == jax_sm.is_kernel_available(m, 2, 4, 32, 32))
    assert got.dtype == _TORCH[dtype]
    _close(got, _np(want), _TOL[dtype])


@pytest.mark.parametrize("kind", ["causal", "padding"])
def test_fused_scale_mask_softmax_availability_matches_jax(kind):
    """The availability predicate over shapes on both sides of each of
    its thresholds (sk, the rows per CUDA block, the multiples of 4)."""
    jmt = JaxMaskType.causal if kind == "causal" else JaxMaskType.padding
    tmt = AttnMaskType.causal if kind == "causal" else AttnMaskType.padding
    jax_sm = jax_functional.FusedScaleMaskSoftmax(False, True, jmt, True,
                                                  None, True, None)
    port_sm = FusedScaleMaskSoftmax(False, True, tmt, True, None, True, None)
    answers = set()
    for sk in (8, 16, 20, 32, 64, 128, 132, 256, 1024, 16384, 16388):
        for sq in (4, 8, 12, 16, 24, 128):
            for b, np_ in ((1, 4), (2, 2), (1, 3), (4, 8)):
                want = jax_sm.is_kernel_available(None, b, np_, sq, sk)
                assert port_sm.is_kernel_available(None, b, np_, sq,
                                                   sk) == want, (b, np_, sq,
                                                                 sk)
                answers.add(want)
    assert answers == {True, False}


def test_generic_fused_scale_mask_softmax_matches_jax():
    jf, tf = _mask_funcs()
    x = _scores4(17, 1, 2, 5, 7)  # a shape the reference kernels refuse
    m = _mask(18, (1, 1, 5, 7))
    want = jax_functional.GenericFusedScaleMaskSoftmax(
        False, False, jf, True, 2.0)(jnp.asarray(x), jnp.asarray(m))
    port = GenericFusedScaleMaskSoftmax(False, False, tf, True, 2.0)
    assert port.is_kernel_available(m, 1, 2, 5, 7)
    _close(port(torch.from_numpy(x), torch.from_numpy(m)), _np(want),
           _TOL["float32"])


def test_scaled_and_masked_plain_versions_count_no_launch():
    registry.reset()
    x = torch.randn(2, 2, 4, 4, requires_grad=True)
    scaled_softmax(x, 1.0).sum().backward()
    scaled_masked_softmax(x, torch.zeros(4, 4, dtype=torch.bool),
                          1.0).sum().backward()
    launches = registry.launches()
    assert launches["scaled_softmax"] == 0
    assert launches["masked_softmax"] == 0 and launches["softmax_bwd"] == 0


def test_masked_softmax_refuses_a_meta_tensor():
    x = torch.empty(2, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.scaled_masked_softmax_fwd(x, x.bool(), 1.0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.scaled_softmax_fwd(x, 1.0)
