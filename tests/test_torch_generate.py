"""apex_tpu_torch GPTModel / generate against apex_tpu's on the CPU: the
slice as a whole.

Small Llama-shaped model (hidden 64, 2 layers, 4 heads, 2 KV groups,
vocab 256, max positions 128, swiglu, rmsnorm, rope). The JAX model is
initialised from a PRNG key, its params go to the port as numpy arrays
through ``from_jax_params``, and the JAX side runs its decode kernels
(window attention, GQA decode, RMSNorm) in Pallas interpret mode.

Tolerances: fp32 logits within 1e-4 (same fp32 arithmetic in another
order) and greedy tokens exactly equal; bf16 logits within 5e-2 of
logits of magnitude ~1 (bf16 roundings of the residual stream placed
differently around fp32 products). The filtered logits of top-k/top-p
sampling are compared exactly: the draws themselves come from different
generators (jax.random vs torch.Generator).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc  # noqa: F401  (registers its gate)
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import generation as jax_gen
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    decode_step,
    filter_logits,
    from_jax_params,
    generate,
    init_cache,
    prefill,
    sample_logits,
)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          num_query_groups=2, ffn_hidden_size=128, vocab_size=256,
          max_position_embeddings=128, normalization="rmsnorm",
          position_embedding_type="rope", activation="swiglu")


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc", "rmsnorm"])
    jax_gqa.force_interpret(True)
    yield
    jax_gqa.force_interpret(False)
    reg.force_interpret(False, ["fused_cc", "rmsnorm"])


@functools.lru_cache(maxsize=None)
def _models(dtype, tie=False):
    """(JAX model, its params, the port's model with the same weights);
    built once per (dtype, tie): neither side mutates them."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model_j = JaxGPTModel(JaxConfig(**KW, compute_dtype=jdt,
                                    use_flash_attention=False,
                                    tie_word_embeddings=tie), decode=True)
    params = model_j.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**KW, compute_dtype=tdt, tie_word_embeddings=tie)
    model_t = GPTModel(cfg, device="cpu")
    model_t.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    return model_j, params, model_t


def _prompt(b=2, plen=7, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(b, plen))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("tie", [False, True])
def test_prefill_and_step_logits_match_jax(dtype, tol, tie):
    model_j, params, model_t = _models(dtype, tie)
    prompt = _prompt()
    b, plen = prompt.shape
    nxt = np.array([[3], [250]])

    cache_j = jax_gen.init_cache(model_j, b)
    # jitted as generate() jits them (eager interpret mode is slow)
    prefill_j = jax.jit(functools.partial(jax_gen.prefill, model_j,
                                          full_logits=True))
    cache_j, full_j = prefill_j(params, cache_j, jnp.asarray(prompt),
                                jnp.arange(plen)[None, :])
    _, step_j = jax.jit(functools.partial(jax_gen.decode_step, model_j))(
        params, cache_j, jnp.asarray(nxt), jnp.full((b, 1), plen))

    cache_t = init_cache(model_t, b)
    cache_t, full_t = prefill(model_t, cache_t, torch.from_numpy(prompt),
                              torch.arange(plen)[None, :], full_logits=True)
    _, step_t = decode_step(model_t, cache_t, torch.from_numpy(nxt),
                            torch.full((b, 1), plen))
    assert full_t.dtype == torch.float32 and full_t.shape == (b, plen, 256)
    assert cache_t.index == plen + 1
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("plen,new", [(7, 9), (1, 4)])
def test_generate_greedy_tokens_exact_fp32(plen, new):
    model_j, params, model_t = _models("float32")
    prompt = _prompt(plen=plen, seed=plen)
    want = np.asarray(jax_gen.generate(model_j, params, jnp.asarray(prompt),
                                       new))
    got = generate(model_t, torch.from_numpy(prompt), new)
    assert got.shape == (2, plen + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_then_pad_matches_jax():
    model_j, params, model_t = _models("float32")
    prompt = _prompt(seed=3)
    free = np.asarray(jax_gen.generate(model_j, params, jnp.asarray(prompt),
                                       6))
    eos = int(free[0, prompt.shape[1] + 1])  # row 0 stops at its 2nd token
    want = np.asarray(jax_gen.generate(model_j, params, jnp.asarray(prompt),
                                       6, eos_token_id=eos, pad_token_id=5))
    got = generate(model_t, torch.from_numpy(prompt), 6, eos_token_id=eos,
                   pad_token_id=5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, prompt.shape[1] + 2:] == 5).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, None), (0.7, None, 0.8), (1.3, 20, 0.5), (1.0, 1000, None)])
def test_filtered_logits_match_jax(monkeypatch, temperature, top_k, top_p):
    """apex_tpu's sample_logits hands its filtered logits to
    jax.random.categorical; capture them there and compare exactly."""
    logits = np.random.RandomState(1).randn(3, 256).astype(np.float32) * 3
    monkeypatch.setattr(jax_gen.jax.random, "categorical",
                        lambda key, lg, axis=-1: lg)
    want = np.asarray(jax_gen.sample_logits(
        jnp.asarray(logits), jax.random.PRNGKey(0), temperature, top_k,
        top_p))
    got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_draws_only_kept_tokens():
    logits = torch.from_numpy(
        np.random.RandomState(2).randn(4, 256).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    kept = torch.isfinite(filter_logits(logits, 0.9, 10, 0.9))
    for _ in range(20):
        tok = sample_logits(logits, gen, 0.9, 10, 0.9)
        assert kept[torch.arange(4), tok].all()
    assert torch.equal(sample_logits(logits, None, 0.0),
                       torch.argmax(logits, dim=-1))


def test_generate_sampling_is_seeded():
    """top-k / top-p sampling inside generate draws from the generator:
    the same seed gives the same tokens, and temperature 0 is greedy."""
    _, _, model_t = _models("float32")
    prompt = torch.from_numpy(_prompt(seed=5))

    def sample(seed, **kw):
        return generate(model_t, prompt, 5,
                        generator=torch.Generator().manual_seed(seed), **kw)

    a = sample(0, temperature=0.9, top_k=8, top_p=0.9)
    assert torch.equal(a, sample(0, temperature=0.9, top_k=8, top_p=0.9))
    assert torch.equal(a[:, :prompt.shape[1]], prompt)
    assert int(a.max()) < KW["vocab_size"]
    assert torch.equal(sample(0, temperature=0.0), generate(model_t, prompt,
                                                           5))


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = TransformerConfig(**KW)
    with pytest.raises(RuntimeError, match="cuda"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        GPTModel(cfg, device="cuda")


def test_generate_validates_length():
    model_t = GPTModel(TransformerConfig(**KW), device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(model_t, torch.zeros(1, 100, dtype=torch.long), 29)
