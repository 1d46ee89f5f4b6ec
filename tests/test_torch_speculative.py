"""apex_tpu_torch's speculative path against apex_tpu's on the CPU:
``spec_verify_attention`` (the int8-cache verify kernel's plain
version), the per-row fill levels of the decode and window kernels'
plain versions, ``speculative_generate`` and the speculative
``ServeEngine``.

The JAX side runs its public functions with the Pallas kernels in
interpret mode; the JAX kernels take one scalar offset, so a batch with
one offset per row is the JAX function under ``jax.vmap`` over rows, as
the JAX serving engine runs them. The models are Llama-shaped (RoPE,
RMSNorm, SwiGLU, GQA), fp32 compute, in the JAX bench's speculative
recipe: the target's layers past the first scaled by 0.25 and a 1-layer
draft sharing its embedding, first layer, final norm and head, so that
drafts are often accepted.

Tolerances: attention outputs within 1e-5 (fp32 softmax and sums over
at most 64 keys in another order, outputs of magnitude ~1); token
streams exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import generation as jax_gen
from apex_tpu.parallel import compression as jax_comp
from apex_tpu.serving import ServeConfig as JaxServeConfig
from apex_tpu.serving import ServeEngine as JaxServeEngine
from apex_tpu.serving import synthetic_trace as jax_synthetic_trace
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.contrib import gqa_decode
from apex_tpu_torch.kernels import fused_cc, registry
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    from_jax_params,
    generate,
    speculative_generate,
)
from apex_tpu_torch.serving import (
    Scheduler,
    ServeConfig,
    ServeEngine,
    synthetic_trace,
)
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
VOCAB = 256
KW = dict(hidden_size=128, num_attention_heads=4, num_query_groups=2,
          ffn_hidden_size=256, vocab_size=VOCAB, max_position_embeddings=96,
          normalization="rmsnorm", position_embedding_type="rope",
          activation="swiglu")
SERVE = dict(batch_buckets=(2, 4), prefill_buckets=(16,), num_slots=4)
K = 3


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc"])
    jax_gqa.force_interpret(True)
    jax_comp.force_interpret(True)
    yield
    jax_comp.force_interpret(False)
    jax_gqa.force_interpret(False)
    reg.force_interpret(False, ["fused_cc"])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

def _int8_cache(rs, T, b, g, d, block):
    """Blockwise int8 codes and scales of random K/V rows: [T, b, nb, B]
    and [T, b, nb, 1] (JAX quantizes them, so both sides read the same
    store)."""
    x = rs.randn(T, b, g * d).astype(np.float32)
    q, s = jax_comp.quantize_rows_blockwise(jnp.asarray(x), block)
    return np.array(q), np.array(s)


@pytest.mark.parametrize("g,rep,d,block", [
    (2, 3, 16, 32),   # g*d = nb*B = 32
    (2, 2, 16, 24),   # 32 lanes in 2 blocks of 24: 16 padding lanes
    (4, 2, 8, 20)])   # 32 lanes in 2 blocks of 20
@pytest.mark.parametrize("start", [0, 23, 59])
def test_spec_verify_plain_matches_jax(g, rep, d, block, start):
    rs = np.random.RandomState(start + block)
    w, T = 5, 64
    q = rs.randn(w, g, rep, d).astype(np.float32)
    kq, ks = _int8_cache(rs, T, 1, g, d, block)
    vq, vs = _int8_cache(rs, T, 1, g, d, block)
    kq, ks, vq, vs = kq[:, 0], ks[:, 0], vq[:, 0], vs[:, 0]
    assert g * d <= kq.shape[1] * kq.shape[2]
    sm = d ** -0.5
    want = jax_fused_cc.spec_verify_attention(
        jnp.asarray(q), *(jnp.asarray(a) for a in (kq, ks, vq, vs)),
        start, sm)
    got = fused_cc.spec_verify_attention(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
        start, sm)
    assert got.shape == (w, g, rep, d) and got.dtype == torch.float32
    _close(got, want)
    # the unfused oracle and the plain version agree too
    _close(fused_cc.spec_verify_reference(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
        start, sm), jax_fused_cc.spec_verify_reference(
        jnp.asarray(q), *(jnp.asarray(a) for a in (kq, ks, vq, vs)),
        start, sm))


def test_spec_verify_batched_per_row_starts_match_jax_vmapped():
    rs = np.random.RandomState(7)
    w, b, g, rep, d, T, block = 4, 3, 2, 2, 16, 64, 24
    q = rs.randn(w, b, g, rep, d).astype(np.float32)
    kq, ks = _int8_cache(rs, T, b, g, d, block)
    vq, vs = _int8_cache(rs, T, b, g, d, block)
    starts = np.array([0, 31, 60], np.int32)
    want = jax.vmap(
        lambda q1, a, b_, c, e, s: jax_fused_cc.spec_verify_attention(
            q1, a, b_, c, e, s, 0.25),
        in_axes=(1, 1, 1, 1, 1, 0), out_axes=1)(
        *(jnp.asarray(x) for x in (q, kq, ks, vq, vs, starts)))
    got = fused_cc.spec_verify_attention(
        *(torch.from_numpy(x) for x in (q, kq, ks, vq, vs, starts)), 0.25)
    assert got.shape == (w, b, g, rep, d)
    _close(got, want)


@pytest.mark.parametrize("window,softcap", [(None, None), (9, 20.0)])
def test_decode_per_row_lengths_match_jax_vmapped(window, softcap):
    rs = np.random.RandomState(11)
    b, g, rep, d, T = 4, 2, 3, 16, 64
    q = rs.randn(b, g, rep, d).astype(np.float32)
    k = rs.randn(T, b, g, d).astype(np.float32)
    v = rs.randn(T, b, g, d).astype(np.float32)
    lengths = np.array([1, 17, 64, 40], np.int32)
    want = jax.vmap(
        lambda q1, k1, v1, n: jax_gqa.gqa_flash_decode(
            q1[None], k1[:, None], v1[:, None], n, 0.25, window,
            softcap)[0], in_axes=(0, 1, 1, 0))(
        *(jnp.asarray(x) for x in (q, k, v, lengths)))
    got = gqa_decode.gqa_flash_decode(
        *(torch.from_numpy(x) for x in (q, k, v, lengths)), 0.25, window,
        softcap)
    _close(got, want)
    # a host int is every row's length
    _close(gqa_decode.gqa_flash_decode(
        *(torch.from_numpy(x) for x in (q, k, v)), 17, 0.25, window,
        softcap)[1], np.asarray(want)[1])


@pytest.mark.parametrize("window,softcap", [(None, None), (6, 25.0)])
def test_window_per_row_starts_match_jax_vmapped(window, softcap):
    rs = np.random.RandomState(13)
    w, b, g, rep, d, T = 5, 3, 2, 2, 16, 64
    q = rs.randn(w, b, g, rep, d).astype(np.float32)
    k = rs.randn(T, b, g, d).astype(np.float32)
    v = rs.randn(T, b, g, d).astype(np.float32)
    starts = np.array([0, 22, 59], np.int32)
    want = jax.vmap(
        lambda q1, k1, v1, s: jax_fused_cc.window_attention(
            q1[:, None], k1[:, None], v1[:, None], s, 0.25, window,
            softcap)[:, 0], in_axes=(1, 1, 1, 0), out_axes=1)(
        *(jnp.asarray(x) for x in (q, k, v, starts)))
    got = fused_cc.window_attention(
        *(torch.from_numpy(x) for x in (q, k, v, starts)), 0.25, window,
        softcap)
    _close(got, want)


def test_plain_versions_count_no_launch():
    registry.reset()
    q = torch.randn(2, 1, 2, 2, 16)
    kq = torch.zeros(8, 1, 2, 16, dtype=torch.int8)
    ks = torch.ones(8, 1, 2, 1)
    fused_cc.spec_verify_attention(q, kq, ks, kq, ks, 0, 0.25)
    assert registry.launches()["spec_verify"] == 0


# ---------------------------------------------------------------------------
# speculative generation and the speculative engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models():
    """JAX and port target/draft pairs with the same weights: a 3-layer
    target whose layers past the first are scaled by 0.25, and a 1-layer
    draft sharing its embedding, layer 0, final norm and head."""
    jcfg = JaxConfig(**KW, num_layers=3, compute_dtype=jnp.float32,
                     use_flash_attention=False)
    params = dict(JaxGPTModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    params["transformer"] = {
        name: jax.tree.map(lambda x: x * (1.0 if name == "layer_0" else 0.25),
                           layer)
        for name, layer in params["transformer"].items()}
    dparams = {key: params[key] for key in ("word_embeddings",
                                            "final_layernorm", "lm_head")}
    dparams["transformer"] = {"layer_0": params["transformer"]["layer_0"]}
    target_j = JaxGPTModel(jcfg, decode=True)
    draft_j = JaxGPTModel(JaxConfig(**KW, num_layers=1,
                                    compute_dtype=jnp.float32,
                                    use_flash_attention=False), decode=True)

    def port(layers, tree):
        cfg = TransformerConfig(**KW, num_layers=layers,
                                compute_dtype=torch.float32)
        model = GPTModel(cfg, device="cpu")
        model.load_state_dict(from_jax_params(
            jax.tree.map(np.asarray, tree), cfg))
        return model

    return (target_j, params, draft_j, dparams, port(3, params),
            port(1, dparams))


TRACE = dict(seed=2, mean_interarrival=1.0, prompt_lens=(3, 8, 14),
             max_new=(6, 11, 17), vocab_size=VOCAB)


def _trace():
    return synthetic_trace(7, **TRACE)


def _streams(completed):
    return {c.rid: c.tokens.tolist() for c in completed}


def test_speculative_generate_matches_jax_and_greedy():
    target_j, params, draft_j, dparams, target, draft = _models()
    prompt = np.random.RandomState(3).randint(0, VOCAB, (2, 6))
    want = np.asarray(jax_gen.speculative_generate(
        target_j, params, draft_j, dparams, jnp.asarray(prompt), 9,
        num_draft_tokens=K))
    got = speculative_generate(target, draft, torch.from_numpy(prompt), 9,
                               num_draft_tokens=K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), generate(target, torch.from_numpy(prompt), 9).numpy())
    # one new token: the prefill's argmax, no round
    np.testing.assert_array_equal(
        speculative_generate(target, draft, torch.from_numpy(prompt), 1,
                             num_draft_tokens=K).numpy(), want[:, :7])
    with pytest.raises(ValueError, match="draft window"):
        speculative_generate(target, draft, torch.zeros(1, 90,
                                                        dtype=torch.long),
                             4, num_draft_tokens=K)


@functools.lru_cache(maxsize=None)
def _port_streams(mode, spec):
    _, _, _, _, target, draft = _models()
    eng = ServeEngine(target, ServeConfig(
        **SERVE, cache_mode=mode, draft_model=draft if spec else None,
        num_draft_tokens=K))
    done, stats = eng.serve(_trace())
    return _streams(done), stats


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_speculative_engine_matches_jax_and_plain_engine(mode):
    """The speculative engine's streams equal JAX's speculative engine's
    in both cache modes. With the bf16 cache they equal the plain
    engine's too; with the int8 cache they need not, in either package:
    the verify window attends its own positions' fresh K/V where the
    plain engine attends them dequantized, so a near tie may break the
    other way (this trace's request 0 differs at its 16th token, in JAX
    as in the port: JAX's plain and speculative engines on this trace
    differ there too)."""
    target_j, params, draft_j, dparams, target, _ = _models()
    jeng = JaxServeEngine(target_j, params, JaxServeConfig(
        **SERVE, cache_mode=mode, draft_model=draft_j,
        draft_params=dparams, num_draft_tokens=K))
    jdone, jstats = jeng.serve(jax_synthetic_trace(7, **TRACE))
    got, stats = _port_streams(mode, True)
    plain, _ = _port_streams(mode, False)
    assert got == _streams(jdone)
    if mode == "bf16":
        assert got == plain
    else:
        first = {rid: next((i for i, (a, b) in enumerate(zip(
            got[rid], plain[rid])) if a != b), None) for rid in got}
        assert first == {0: 15, **{rid: None for rid in got if rid}}
    assert stats["acceptance_rate"] == jstats["acceptance_rate"]
    assert stats["acceptance_rate"] > 0.3  # the draft often agrees
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["decode_steps"] < _port_streams(mode, False)[1][
        "decode_steps"]
    if mode == "bf16":  # and the plain engine is greedy generate
        for r in _trace():
            want = generate(target, torch.as_tensor(r.prompt)[None],
                            r.max_new_tokens)[0, len(r.prompt):]
            assert plain[r.rid] == want.tolist()


def test_speculative_round_quarantines_a_poisoned_slot():
    _, _, _, _, target, draft = _models()
    clean, _ = _port_streams("int8", True)
    eng = ServeEngine(target, ServeConfig(**SERVE, cache_mode="int8",
                                          draft_model=draft,
                                          num_draft_tokens=K))
    eng.poison_slot(0, at_call=1)
    sched = Scheduler(eng)
    done = sched.run(_trace())
    reasons = {c.rid: c.finish_reason for c in done}
    assert list(reasons.values()).count("poisoned") == 1
    for rid, toks in _streams(done).items():
        n = len(toks) if reasons[rid] == "poisoned" else None
        assert toks == clean[rid][:n]
    # both stores' rows of the quarantined slot were zeroed
    eng2 = ServeEngine(target, ServeConfig(**SERVE, cache_mode="int8",
                                           draft_model=draft,
                                           num_draft_tokens=K))
    first = eng2.prefill([0, 1], [np.arange(5), np.arange(7)])
    eng2.poison_slot(1)
    emit, counts, finite = eng2.decode([0, 1], first)
    assert finite.tolist() == [True, False]
    assert counts[1] == 1 and emit[1, 0] == 0 and 1 <= counts[0] <= K + 1
    assert eng2.slot_lengths().tolist()[:2] == [5 + counts[0], 0]
    for store in (eng2._store, eng2._draft_store):
        assert int(store["lengths"][1]) == 0
        for leaf in store["keys"] + store["values"]:
            assert not leaf["q"][:, 1].any() and not leaf["scale"][:, 1].any()


def test_speculative_engine_validation():
    _, _, _, _, target, draft = _models()
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(target, ServeConfig(**SERVE, draft_model=draft,
                                        temperature=0.7))
    with pytest.raises(ValueError, match="num_draft_tokens"):
        ServeEngine(target, ServeConfig(**SERVE, draft_model=draft,
                                        num_draft_tokens=0))
    other = GPTModel(TransformerConfig(**{**KW, "vocab_size": 128},
                                       num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(target, ServeConfig(**SERVE, draft_model=other))
    eng = ServeEngine(target, ServeConfig(**SERVE, draft_model=draft,
                                          num_draft_tokens=K))
    assert eng.spec_enabled and eng.decode_headroom == K
    assert eng.draft_kv_cache_bytes() < eng.kv_cache_bytes()
