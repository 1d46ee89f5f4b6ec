"""apex_tpu_torch multi-head attention modules (contrib/multihead_attn)
against apex_tpu's on the CPU.

The JAX modules are initialised from a PRNG key and their flax params go
to the port through ``models.from_jax_params``. The JAX side's flash
path runs ``apex_tpu.contrib.fmha``'s Pallas kernels in interpret mode;
the port's takes the kernels' plain versions. Inputs, masks and output
gradients come from numpy seeds; gradients are taken with respect to
the input and every parameter (``jax.vjp`` against autograd).

Tolerances: fp32 outputs and gradients within 1e-5 relative plus 1e-5
of the largest magnitude (the same fp32 products and softmax, summed in
another order). With a bf16 input the projections still run in fp32
(the fp32 weights promote it, as in JAX), but the einsum path rounds
its context to the input's bf16, where an fp32 difference in the last
place may round the other way: one bf16 ulp, 2**-7 relative, plus 2**-8
of the largest magnitude. Never under 1e-5 absolute: the key bias's
gradient is zero in exact arithmetic (it shifts all scores of a row by
one amount, which the softmax cancels), so both sides give rounding
noise of ~1e-6 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.fmha as jax_fmha
from apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as JaxEncdec,
)
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JaxSelf
from apex_tpu_torch.contrib import EncdecMultiheadAttn, SelfMultiheadAttn
from apex_tpu_torch.contrib.multihead_attn import _core
from apex_tpu_torch.models import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

H, HEADS, BATCH = 128, 2, 2
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -8)}
ATOL_FLOOR = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fmha, "_INTERPRET", True)
    monkeypatch.setattr(jax_fmha, "_use_pallas", lambda: True)


def _close(got, want, dtype, what):
    rtol, scaled = _TOL[dtype]
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=max(scaled * np.abs(want).max(),
                                        ATOL_FLOOR),
                               err_msg=what)


def _masks(rng, sq, sk, which):
    attn = key_pad = None
    if which in ("attn", "both"):
        attn = rng.rand(sq, sk) < 0.3
        attn[:, 0] = False  # every row keeps a key
    if which == "additive":
        attn = (rng.randn(sq, sk) * 2).astype(np.float32)
    if which in ("pad", "both"):
        key_pad = np.zeros((BATCH, sk), bool)
        key_pad[0, -sk // 4:] = True
    return attn, key_pad


def _compare(jax_mod, port, inputs, dtype, attn, key_pad, seed,
             perturb=None):
    """Forward and every gradient of the JAX module and the port's, with
    the JAX params (passed through ``perturb``, if given) loaded into the
    port."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a, jdt) for a in inputs]
    params = jax_mod.init(jax.random.PRNGKey(seed), *jx,
                          is_training=False)["params"]
    if perturb is not None:
        params = perturb(params)
    np_params = jax.tree.map(np.asarray, params)
    port.load_state_dict(from_jax_params(np_params))
    jmask = None if attn is None else jnp.asarray(attn)
    jpad = None if key_pad is None else jnp.asarray(key_pad)

    def f(p, *xs):
        return jax_mod.apply({"params": p}, *xs, key_padding_mask=jpad,
                             attn_mask=jmask, is_training=False)

    want, vjp = jax.vjp(f, params, *jx)
    dy = np.random.RandomState(seed + 1).randn(*want.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(dy, want.dtype))

    tx = [torch.from_numpy(a).to(tdt).requires_grad_() for a in inputs]
    got = port(*tx, key_padding_mask=(None if key_pad is None
                                      else torch.from_numpy(key_pad)),
               attn_mask=None if attn is None else torch.from_numpy(attn),
               is_training=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, dtype, "output")
    got.backward(torch.from_numpy(dy))
    for name, g in from_jax_params(jax.tree.map(np.asarray,
                                                jgrads[0])).items():
        _close(dict(port.named_parameters())[name].grad, g.numpy(), dtype,
               name)
    for i, t in enumerate(tx):
        _close(t.grad, jgrads[1 + i], dtype, f"input {i}")


SELF_CASES = [
    # (impl, separate_qkv_params, bias, masks, dtype)
    ("fast", False, False, None, "float32"),
    ("fast", False, True, None, "bfloat16"),
    ("fast", True, True, None, "float32"),
    ("default", False, True, None, "float32"),
    ("default", True, False, None, "bfloat16"),
    ("fast", False, True, "attn", "float32"),
    ("fast", True, False, "pad", "float32"),
    ("default", False, True, "both", "bfloat16"),
    ("fast", False, True, "additive", "float32"),
]


@pytest.mark.parametrize("impl,separate,bias,masks,dtype", SELF_CASES)
def test_self_multihead_attn_matches_jax(impl, separate, bias, masks, dtype):
    s = 128
    rng = np.random.RandomState(len(impl) + 2 * separate + 4 * bias)
    x = rng.randn(s, BATCH, H).astype(np.float32)
    attn, key_pad = _masks(rng, s, s, masks)
    kw = dict(embed_dim=H, num_heads=HEADS, bias=bias, impl=impl,
              separate_qkv_params=separate,
              mask_additive=masks == "additive")
    port = SelfMultiheadAttn(**kw, device="cpu")
    _compare(JaxSelf(**kw), port, [x], dtype, attn, key_pad, 3)


@pytest.mark.parametrize("sk,bias,masks,dtype", [
    (128, False, None, "float32"),     # flash
    (128, True, None, "bfloat16"),     # flash
    (96, True, None, "float32"),       # sq != sk: einsum
    (128, True, "both", "float32"),
    (96, False, "pad", "bfloat16"),
])
def test_encdec_multihead_attn_matches_jax(sk, bias, masks, dtype):
    sq = 128
    rng = np.random.RandomState(sk + bias)
    q = rng.randn(sq, BATCH, H).astype(np.float32)
    k = rng.randn(sk, BATCH, H).astype(np.float32)
    attn, key_pad = _masks(rng, sq, sk, masks)
    kw = dict(embed_dim=H, num_heads=HEADS, bias=bias)
    port = EncdecMultiheadAttn(**kw, device="cpu")
    _compare(JaxEncdec(**kw), port, [q, k], dtype, attn, key_pad, 5)


def test_parameters_keep_the_jax_names_and_layouts():
    x = jnp.zeros((8, 1, 64))
    for jax_mod, port in (
            (JaxSelf(64, 2, bias=True), SelfMultiheadAttn(64, 2, bias=True,
                                                          device="cpu")),
            (JaxSelf(64, 2, separate_qkv_params=True),
             SelfMultiheadAttn(64, 2, separate_qkv_params=True,
                               device="cpu")),
            (JaxEncdec(64, 2, bias=True), EncdecMultiheadAttn(
                64, 2, bias=True, device="cpu"))):
        args = (x, x) if isinstance(jax_mod, JaxEncdec) else (x,)
        tree = jax_mod.init(jax.random.PRNGKey(0), *args)["params"]
        want = {k: tuple(v.shape) for k, v in from_jax_params(
            jax.tree.map(np.asarray, tree)).items()}
        got = {k: tuple(v.shape) for k, v in port.named_parameters()}
        assert got == want


def test_dropout_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = torch.full((400, 500), 0.5)
    for rate in (0.1, 0.5):
        out = _core.dropout(p, rate, gen)
        dropped = (out == 0).float().mean().item()
        # 200,000 draws: 5 standard deviations of the dropped share
        sigma = (rate * (1 - rate) / p.numel()) ** 0.5
        assert abs(dropped - rate) < 5 * sigma, (rate, dropped)
        kept = out[out != 0]
        torch.testing.assert_close(kept, torch.full_like(kept,
                                                         0.5 / (1 - rate)))
    assert torch.equal(_core.dropout(p, 1.0, gen), torch.zeros_like(p))


def test_dropout_in_the_module_draws_from_its_generator():
    mha = SelfMultiheadAttn(64, 2, dropout=0.3, device="cpu")
    x = torch.randn(16, 2, 64, generator=torch.Generator().manual_seed(1))

    def run(seed, **kw):
        return mha(x, generator=torch.Generator().manual_seed(seed), **kw)

    torch.testing.assert_close(run(7), run(7), rtol=0, atol=0)
    assert not torch.equal(run(7), run(8))
    # no dropout outside training, as JAX's is_training=False
    torch.testing.assert_close(run(7, is_training=False), run(8, is_training=False),
                               rtol=0, atol=0)
    mha.eval()
    torch.testing.assert_close(run(7), run(7, is_training=False), rtol=0,
                               atol=0)


def _perturb_norm(seed):
    """A params transform giving ``lyr_norm`` a weight and bias that are
    not the identity's ones and zeros."""
    def perturb(params):
        rng = np.random.RandomState(seed)
        params = jax.tree.map(lambda a: a, params)
        norm = dict(params["lyr_norm"])
        norm["weight"] = norm["weight"] + jnp.asarray(
            0.2 * rng.randn(*norm["weight"].shape), jnp.float32)
        norm["bias"] = norm["bias"] + jnp.asarray(
            0.2 * rng.randn(*norm["bias"].shape), jnp.float32)
        return {**params, "lyr_norm": norm}
    return perturb


@pytest.mark.parametrize("impl,masks,dtype", [
    ("fast", None, "float32"),        # flash
    ("fast", None, "bfloat16"),       # flash
    ("default", "both", "float32"),   # einsum with masks
    ("fast", "pad", "bfloat16"),
])
def test_self_include_norm_add_matches_jax(impl, masks, dtype):
    """include_norm_add: lyr_norm on the fp32 query, cast back, and the
    residual add; lyr_norm's weight and bias get their gradients."""
    s = 128
    rng = np.random.RandomState(11)
    x = rng.randn(s, BATCH, H).astype(np.float32)
    attn, key_pad = _masks(rng, s, s, masks)
    kw = dict(embed_dim=H, num_heads=HEADS, bias=True, impl=impl,
              include_norm_add=True)
    port = SelfMultiheadAttn(**kw, device="cpu")
    assert {"lyr_norm.weight", "lyr_norm.bias"} <= dict(
        port.named_parameters()).keys()
    _compare(JaxSelf(**kw), port, [x], dtype, attn, key_pad, 7,
             perturb=_perturb_norm(12))


@pytest.mark.parametrize("sk,masks,dtype", [
    (128, None, "float32"), (96, "pad", "bfloat16")])
def test_encdec_include_norm_add_matches_jax(sk, masks, dtype):
    sq = 128
    rng = np.random.RandomState(sk)
    q = rng.randn(sq, BATCH, H).astype(np.float32)
    k = rng.randn(sk, BATCH, H).astype(np.float32)
    attn, key_pad = _masks(rng, sq, sk, masks)
    kw = dict(embed_dim=H, num_heads=HEADS, bias=True, include_norm_add=True)
    port = EncdecMultiheadAttn(**kw, device="cpu")
    _compare(JaxEncdec(**kw), port, [q, k], dtype, attn, key_pad, 9,
             perturb=_perturb_norm(13))


def test_include_norm_add_and_bad_arguments_raise():
    """include_norm_add builds lyr_norm (it raised before LayerNorm was
    ported); bad arguments raise."""
    for cls in (SelfMultiheadAttn, EncdecMultiheadAttn):
        mod = cls(64, 2, include_norm_add=True, device="cpu")
        assert mod.lyr_norm.weight.shape == (64,)
        assert cls(64, 2, device="cpu").lyr_norm is None
        with pytest.raises(ValueError, match="impl"):
            cls(64, 2, impl="cutlass", device="cpu")
        with pytest.raises(ValueError, match="multiple of num_heads"):
            cls(64, 3, device="cpu")


def test_need_weights_returns_a_pair():
    x = torch.randn(8, 1, 64)
    out, weights = SelfMultiheadAttn(64, 2, device="cpu")(x,
                                                          need_weights=True)
    assert out.shape == x.shape and weights is None
    out, weights = EncdecMultiheadAttn(64, 2, device="cpu")(
        x, x, need_weights=True)
    assert out.shape == x.shape and weights is None
