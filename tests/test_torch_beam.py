"""apex_tpu_torch's beam search and shared-prefix generation against
apex_tpu's on the CPU: ``beam_search`` (eos, length penalty, one beam),
``prefill_prefix`` with ``generate(prefix_state=...)`` (a batch-1 prefix
broadcast, reuse across calls, the validation errors), and the KV
cache's batch-axis row operations they stand on.

The model is a tiny Llama-shaped decoder (2 layers, hidden 64, 4 heads
in 2 groups, RMSNorm, RoPE, SwiGLU, vocab 128, 64 positions), fp32
compute, initialised in JAX and carried to the port through
``from_jax_params``; the JAX side runs its decode kernel in Pallas
interpret mode.

Tolerances: tokens exactly; beam scores within 1e-5 (fp32 log-softmax
sums over a few tokens, computed in another order); cache rows exactly
(they are copies).
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
    KVCache,
    TransformerConfig,
    beam_search,
    from_jax_params,
    generate,
    init_cache,
    prefill_prefix,
)
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 128
KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          num_query_groups=2, vocab_size=VOCAB, max_position_embeddings=64,
          normalization="rmsnorm", position_embedding_type="rope",
          activation="swiglu")


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc"])
    jax_gqa.force_interpret(True)
    yield
    jax_gqa.force_interpret(False)
    reg.force_interpret(False, ["fused_cc"])


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = JaxConfig(**KW, compute_dtype=jnp.float32,
                     use_flash_attention=False)
    params = JaxGPTModel(jcfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**KW, compute_dtype=torch.float32)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    return JaxGPTModel(jcfg, decode=True), params, model


def _prompt(b, s, seed):
    return np.random.RandomState(seed).randint(1, VOCAB, (b, s))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _greedy_token(model, prompt, step):
    """The greedy continuation's token ``step`` of row 0 (an eos that
    the beams will meet)."""
    out = generate(model, torch.from_numpy(prompt), step + 1)
    return int(out[0, prompt.shape[1] + step])


@pytest.mark.parametrize("beams,penalty,eos", [
    (3, 0.7, "greedy"), (4, 1.0, None), (2, 1.5, "greedy")])
def test_beam_search_matches_jax(beams, penalty, eos):
    model_j, params, model = _models()
    prompt = _prompt(2, 5, beams)
    if eos == "greedy":
        eos = _greedy_token(model, prompt, 2)
    want, want_s = jax_gen.beam_search(
        model_j, params, jnp.asarray(prompt), 7, beams,
        length_penalty=penalty, eos_token_id=eos, pad_token_id=0)
    got, got_s = beam_search(model, torch.from_numpy(prompt), 7, beams,
                             length_penalty=penalty, eos_token_id=eos,
                             pad_token_id=0)
    assert got.shape == (2, 12) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    if eos is not None:  # a finished beam extends with pad only
        row = got[0, 5:].tolist()
        if eos in row:
            assert all(t == 0 for t in row[row.index(eos) + 1:])


def test_one_beam_is_greedy():
    model_j, params, model = _models()
    prompt = _prompt(3, 6, 11)
    got, scores = beam_search(model, torch.from_numpy(prompt), 8, 1)
    np.testing.assert_array_equal(
        got.numpy(), generate(model, torch.from_numpy(prompt), 8).numpy())
    want, want_s = jax_gen.beam_search(model_j, params, jnp.asarray(prompt),
                                       8, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        beam_search(model, torch.zeros(1, 60, dtype=torch.long), 8, 2)


# ---------------------------------------------------------------------------
# shared-prefix generation
# ---------------------------------------------------------------------------

def test_prefix_generate_matches_jax_and_the_full_prompt():
    model_j, params, model = _models()
    prefix = _prompt(1, 9, 5)
    state = prefill_prefix(model, torch.from_numpy(prefix))
    jstate = jax_gen.prefill_prefix(model_j, params, jnp.asarray(prefix))
    assert state[1] == jstate[1] == 9
    before = [k.clone() for k in state[0].keys]
    for seed, b in ((6, 3), (7, 2)):  # one prefix, two calls
        suffix = _prompt(b, 4, seed)
        got = generate(model, torch.from_numpy(suffix), 6,
                       prefix_state=state)
        want = jax_gen.generate(model_j, params, jnp.asarray(suffix), 6,
                                prefix_state=jstate)
        assert got.shape == (b, 4 + 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        full = np.concatenate([np.repeat(prefix, b, 0), suffix], axis=1)
        np.testing.assert_array_equal(
            got.numpy(),
            generate(model, torch.from_numpy(full), 6).numpy()[:, 9:])
    # the shared prefix is as it was after both calls
    for k, k0 in zip(state[0].keys, before):
        assert torch.equal(k, k0)
    assert state[0].batch == 1 and state[0].index == 9
    # a batch-b prefix serves a batch-b suffix, and only that
    prefix2 = _prompt(2, 9, 8)
    state2 = prefill_prefix(model, torch.from_numpy(prefix2))
    suffix = _prompt(2, 3, 9)
    want = jax_gen.generate(
        model_j, params, jnp.asarray(suffix), 5,
        prefix_state=jax_gen.prefill_prefix(model_j, params,
                                            jnp.asarray(prefix2)))
    np.testing.assert_array_equal(
        generate(model, torch.from_numpy(suffix), 5,
                 prefix_state=state2).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="only batch-1 prefixes"):
        generate(model, torch.from_numpy(_prompt(3, 3, 1)), 5,
                 prefix_state=state2)


def test_prefix_validation_matches_jax():
    model_j, params, model = _models()
    with pytest.raises(ValueError, match="no room") as got:
        prefill_prefix(model, torch.zeros(1, 64, dtype=torch.long))
    with pytest.raises(ValueError, match="no room") as want:
        jax_gen.prefill_prefix(model_j, params, jnp.zeros((1, 64), jnp.int32))
    assert str(got.value) == str(want.value)
    state = prefill_prefix(model, torch.from_numpy(_prompt(1, 40, 2)))
    jstate = jax_gen.prefill_prefix(model_j, params,
                                    jnp.asarray(_prompt(1, 40, 2)))
    with pytest.raises(ValueError, match="prefix \\(40\\)") as got:
        generate(model, torch.ones(1, 10, dtype=torch.long), 15,
                 prefix_state=state)
    with pytest.raises(ValueError, match="prefix \\(40\\)") as want:
        jax_gen.generate(model_j, params, jnp.ones((1, 10), jnp.int32), 15,
                         prefix_state=jstate)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the cache's row operations
# ---------------------------------------------------------------------------

def _filled_cache(b):
    cache = KVCache(2, 8, b, 2, 4, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(b)
    for t in cache.keys + cache.values:
        t.copy_(torch.randn(t.shape, generator=gen))
    cache.set_lengths(5)
    return cache


def test_cache_row_ops_match_jnp():
    cache = _filled_cache(3)
    index = torch.tensor([2, 0, 0, 1])
    for got, want in (
            (cache.reorder(index),
             lambda x: jnp.take(x, jnp.asarray(index.numpy()), axis=1)),
            (cache.repeat_rows(2), lambda x: jnp.repeat(x, 2, axis=1))):
        for g, x in zip(got.keys + got.values, cache.keys + cache.values):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(want(x.numpy())))
        assert got.index == 5 and got.lengths.tolist() == [5] * got.batch
    one = _filled_cache(1)
    wide = one.broadcast_rows(4)
    for g, x in zip(wide.keys, one.keys):
        assert g.is_contiguous() and g.shape[1] == 4
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jnp.broadcast_to(x.numpy(), g.shape)))
    # the copies are real: writing one leaves the source as it was
    before = one.keys[0].clone()
    wide.keys[0].add_(1.0)
    same = one.broadcast_rows(1)
    same.keys[0].add_(1.0)
    assert torch.equal(one.keys[0], before)
    with pytest.raises(ValueError, match="only batch-1"):
        _filled_cache(2).broadcast_rows(3)
    # a fresh cache's levels start at 0
    assert init_cache(_models()[2], 2).lengths.tolist() == [0, 0]
