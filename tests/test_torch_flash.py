"""apex_tpu_torch flash attention (contrib/fmha: the kernels' plain
versions and the autograd ``flash_attention``) against apex_tpu's on the
CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors.
The JAX side runs ``apex_tpu.contrib.fmha``'s Pallas kernels in
interpret mode (``_flash_fwd_pallas`` for O and lse,
``_flash_bwd_pallas`` for dq, dk and dv, and ``flash_attention`` under
``jax.vjp``), with the TPU tiles of each case; the port's kernels pick
their own tiles, so the cases also cover how JAX cuts the sequence.
Inputs and output gradients come from numpy seeds.

Tolerances: fp32 O and lse within 1e-5 relative and 1e-5 absolute (the
same fp32 operations with sums in another order: measured <= 2e-6);
fp32 gradients within 1e-5 relative plus 1e-5 of the largest |gradient|
(measured <= 1e-6 of it), and never under 1e-5 absolute: with window 1
each row sees only its own key, so ds = p * (do.v - do.o) cancels to
rounding noise (~1e-6 from terms of size ~10) on both sides. bf16
inputs are upcast to the same fp32 values on both sides, so lse keeps
the fp32 tolerance, while O and the gradients, rounded to bf16 from
fp32 values that differ in the last place, may round the other way: one
bf16 ulp (2**-7 relative) plus 2**-8 of the largest magnitude for
entries near 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.fmha as jax_fmha
from apex_tpu_torch.contrib import FMHA, fmha
from apex_tpu_torch.kernels import registry
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fmha, "_INTERPRET", True)
    monkeypatch.setattr(jax_fmha, "_use_pallas", lambda: True)


_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -8)}
ATOL_FLOOR = 1e-5
B, N = 1, 2

# (causal, window, alibi, (block_q, block_k), s, d, dtype)
CASES = [
    (True, None, False, (64, 64), 128, 64, "float32"),
    (False, None, False, (64, 64), 128, 64, "float32"),
    (True, 1, False, (64, 64), 256, 64, "float32"),
    (True, 37, False, (64, 64), 256, 64, "float32"),
    (True, 64, False, (64, 64), 256, 64, "float32"),
    (True, 100, False, (64, 64), 256, 64, "float32"),
    (True, None, True, (64, 64), 128, 64, "float32"),
    (False, None, True, (64, 128), 256, 64, "float32"),
    (True, 37, True, (128, 64), 256, 64, "float32"),
    (True, None, False, (64, 128), 256, 64, "float32"),
    (True, 100, False, (128, 64), 256, 128, "float32"),
    (False, None, False, (64, 64), 128, 128, "float32"),
    (True, None, False, (64, 64), 128, 64, "bfloat16"),
    (True, 37, True, (64, 128), 256, 64, "bfloat16"),
    (False, None, False, (128, 64), 256, 128, "bfloat16"),
]
IDS = [f"{'causal' if c else 'full'}-w{w}-{'alibi' if a else 'noalibi'}-"
       f"b{bq}x{bk}-s{s}-d{d}-{dt}" for c, w, a, (bq, bk), s, d, dt in CASES]


def _inputs(case):
    causal, window, alibi, _, s, d, dtype = case
    rng = np.random.RandomState(s + d + (window or 0) + 7 * alibi + causal)
    arrays = [rng.randn(B, N, s, d).astype(np.float32) for _ in range(4)]
    slopes = (rng.uniform(0.01, 0.2, size=N).astype(np.float32)
              if alibi else None)
    return arrays, slopes


@functools.lru_cache(maxsize=None)
def _reference(case):
    """JAX's O, lse (forward kernel), dq, dk, dv (backward kernels, from
    that O and lse), and the output and gradients of ``flash_attention``
    under ``jax.vjp``, all as fp32 numpy arrays."""
    causal, window, alibi, (bq, bk), s, d, dtype = case
    (q, k, v, do), slopes = _inputs(case)
    jq, jk, jv, jdo = (jnp.asarray(a, _JAX[dtype]) for a in (q, k, v, do))
    jsl = None if slopes is None else jnp.asarray(slopes)
    scale = 1.0 / np.sqrt(d)
    o, lse = jax_fmha._flash_fwd_pallas(jq, jk, jv, scale, causal, bq, bk,
                                        window, jsl)
    grads = jax_fmha._flash_bwd_pallas(jq, jk, jv, o, lse, jdo, scale,
                                       causal, bq, bk, window, jsl)
    out, vjp = jax.vjp(
        lambda a, b, c: jax_fmha.flash_attention(a, b, c, causal, None, bq,
                                                 bk, window, jsl),
        jq, jk, jv)
    f32 = functools.partial(np.array, dtype=np.float32)
    return dict(o=f32(o.astype(jnp.float32)), lse=f32(lse),
                grads=[f32(g.astype(jnp.float32)) for g in grads],
                out=f32(out.astype(jnp.float32)),
                vjp=[f32(g.astype(jnp.float32)) for g in vjp(jdo)])


def _torch(case):
    (q, k, v, do), slopes = _inputs(case)
    dt = _TORCH[case[-1]]
    return ([torch.from_numpy(a).to(dt) for a in (q, k, v, do)],
            None if slopes is None else torch.from_numpy(slopes))


def _close(got, want, dtype):
    rtol, scaled_atol = _TOL[dtype]
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=rtol,
        atol=max(scaled_atol * np.abs(want).max(), ATOL_FLOOR))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_fwd_plain_matches_jax_kernel(case):
    causal, window, _, _, s, d, dtype = case
    (q, k, v, _), slopes = _torch(case)
    want = _reference(case)
    o, lse = fmha.flash_fwd_plain(q, k, v, 1.0 / np.sqrt(d), causal, window,
                                  slopes)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, N, s)
    _close(o, want["o"], dtype)
    _close(lse, want["lse"], "float32")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_plain_matches_jax_kernels(case):
    causal, window, _, _, _, d, dtype = case
    (q, k, v, do), slopes = _torch(case)
    want = _reference(case)
    o = torch.from_numpy(want["o"]).to(q.dtype)
    lse = torch.from_numpy(want["lse"])
    got = fmha.flash_bwd_plain(q, k, v, o, lse, do, 1.0 / np.sqrt(d), causal,
                               window, slopes)
    for g, w in zip(got, want["grads"]):
        assert g.dtype == q.dtype and g.shape == q.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_attention_autograd_matches_jax(case):
    causal, window, _, (bq, bk), _, _, dtype = case
    (q, k, v, do), slopes = _torch(case)
    want = _reference(case)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fmha.flash_attention(q, k, v, causal, None, bq, bk, window, slopes)
    out.backward(do)
    _close(out, want["out"], dtype)
    for t, w in zip((q, k, v), want["vjp"]):
        assert t.grad.dtype == t.dtype
        _close(t.grad, w, dtype)


@pytest.mark.parametrize("causal,window,alibi", [
    (True, None, False), (True, 5, True), (False, None, True)])
def test_attention_reference_matches_jax(causal, window, alibi):
    """Including keys longer than the queries (the last query sees the
    last key)."""
    rng = np.random.RandomState(11)
    q = rng.randn(2, 3, 7, 16).astype(np.float32)
    k, v = (rng.randn(2, 3, 12, 16).astype(np.float32) for _ in range(2))
    slopes = rng.uniform(0.01, 0.2, size=3).astype(np.float32)
    want = jax_fmha._attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), 0.3, causal, window,
        jnp.asarray(slopes) if alibi else None)
    got = fmha.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), 0.3, causal, window,
        torch.from_numpy(slopes) if alibi else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _small(seed=0, s=16, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 2, s, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(causal=False, window=4), ValueError, "requires causal"),
    (dict(window=True), ValueError, "positive"),
    (dict(window=0), ValueError, "positive"),
    (dict(window=2.5), ValueError, "positive"),
    (dict(scale="0.1"), TypeError, "python number"),
])
def test_argument_checks_match_jax(kwargs, exc, match):
    arrays = _small()
    with pytest.raises(exc, match=match):
        jax_fmha.flash_attention(*(jnp.asarray(a) for a in arrays), **kwargs)
    with pytest.raises(exc, match=match):
        fmha.flash_attention(*(torch.from_numpy(a) for a in arrays), **kwargs)


def test_tensor_scale_and_bad_blocks_are_refused():
    q, k, v = (torch.from_numpy(a) for a in _small())
    with pytest.raises(TypeError, match="python number"):
        fmha.flash_attention(q, k, v, scale=torch.tensor(0.1))
    for block in (0, -64, 64.0, True):
        with pytest.raises(ValueError, match="block_q"):
            fmha.flash_attention(q, k, v, block_q=block)
        with pytest.raises(ValueError, match="block_k"):
            fmha.flash_attention(q, k, v, block_k=block)


def test_numpy_window_and_default_scale():
    """A numpy integer window is a window; the default scale is
    1/sqrt(head_dim)."""
    q, k, v = (torch.from_numpy(a) for a in _small(3))
    got = fmha.flash_attention(q, k, v, window=np.int64(3))
    want = fmha.attention_reference(q, k, v, 8 ** -0.5, True, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_saves_no_score_matrix_and_slopes_get_zero_gradient():
    s = 64
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _small(5, s=s, d=16))
    slopes = torch.tensor([0.1, 0.05], requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fmha.flash_attention(q, k, v, alibi_slopes=slopes)
    # q, k, v, o, lse and the slopes: no [s, s] matrix
    assert sorted(saved) == sorted([(1, 2, s, 16)] * 4 + [(1, 2, s), (2,)])
    out.sum().backward()
    assert torch.equal(slopes.grad, torch.zeros(2))
    assert all(t.grad is not None for t in (q, k, v))


def test_fmha_class_matches_jax():
    rng = np.random.RandomState(9)
    qkv = rng.randn(2, 128, 3, 2, 64).astype(np.float32)
    for causal in (False, True):
        want = jax_fmha.FMHA(causal)(jnp.asarray(qkv))
        got = FMHA(causal)(torch.from_numpy(qkv))
        assert got.shape == (2, 128, 2, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert FMHA.supported_seq_lens == jax_fmha.FMHA.supported_seq_lens


def test_plain_versions_count_no_launch():
    registry.reset()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _small(2))
    fmha.flash_attention(q, k, v).sum().backward()
    launches = registry.launches()
    assert {"flash_fwd", "flash_dq", "flash_dkv"} <= launches.keys()
    assert not any(launches.values()), launches


def test_non_cpu_non_cuda_tensors_raise():
    q = torch.empty(1, 2, 128, 64, device="meta")
    lse = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fmha.flash_fwd(q, q, q, 0.125, True)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fmha.flash_bwd(q, q, q, q, lse, q, 0.125, True)
