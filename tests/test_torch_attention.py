"""apex_tpu_torch KV-cache attention (kernels/fused_cc.window_attention,
contrib/gqa_decode.gqa_flash_decode, one ParallelTransformerLayer in
decode mode) against apex_tpu's on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors.
The JAX side runs its public functions with the Pallas kernels in
interpret mode (and through its einsum oracle where no tile divides the
cache). Inputs come from numpy seeds.

Tolerances: 2e-5 for the attention functions (fp32 softmax and sums in
another order, outputs of magnitude ~1); fp32 layer outputs within
1e-4 relative, bf16 layer outputs within 2e-2 (a few bf16 ulps of
rounding placed differently around the fp32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc as jax_fused_cc
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models.transformer_lm import (
    ParallelTransformerLayer as JaxLayer,
)
from apex_tpu.models.transformer_lm import RopeScaling as JaxRopeScaling
from apex_tpu.models.transformer_lm import TransformerConfig as JaxConfig
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.contrib import gqa_decode
from apex_tpu_torch.kernels import fused_cc
from apex_tpu_torch.models import (
    KVCache,
    RopeScaling,
    TransformerConfig,
    from_jax_params,
)
from apex_tpu_torch.models.transformer_lm import ParallelTransformerLayer
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc", "rmsnorm"])
    jax_gqa.force_interpret(True)
    yield
    jax_gqa.force_interpret(False)
    reg.force_interpret(False, ["fused_cc", "rmsnorm"])


def _inputs(seed, q_shape, T, b, g, d, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(*q_shape).astype(np.float32)
    k = rng.randn(T, b, g, d).astype(np.float32)
    v = rng.randn(T, b, g, d).astype(np.float32)
    jax_dtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(a, jax_dtype) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(torch_dtype) for a in (q, k, v)]
    return jx, tx


WINDOW_SOFTCAP = [(None, None), (7, None), (None, 30.0), (6, 25.0)]


# fp32 over every option; bf16 inputs (both sides upcast the same bf16
# values) on one cache length
WINDOW_CASES = ([(w, c, T, "float32") for w, c in WINDOW_SOFTCAP
                 for T in (64, 100)]  # 100: no 32-tile divides it
                + [(w, c, 64, "bfloat16") for w, c in WINDOW_SOFTCAP])
DECODE_CASES = ([(w, c, g, r, "float32") for w, c in WINDOW_SOFTCAP
                 for g, r in ((2, 2), (4, 1), (1, 4))]
                + [(w, c, 2, 2, "bfloat16") for w, c in WINDOW_SOFTCAP])


@pytest.mark.parametrize("window,softcap,T,dtype", WINDOW_CASES)
def test_window_attention_matches_jax(window, softcap, T, dtype):
    w, b, g, rep, d = 5, 2, 2, 3, 16
    (qj, kj, vj), (qt, kt, vt) = _inputs(T + g, (w, b, g, rep, d), T, b, g,
                                         d, dtype)
    for start in (0, 13, T - w):
        want = jax_fused_cc.window_attention(qj, kj, vj, start, 0.25,
                                             window=window, softcap=softcap,
                                             block_t=32)
        got = fused_cc.window_attention(qt, kt, vt, start, 0.25,
                                        window=window, softcap=softcap)
        assert got.dtype == torch.float32 and got.shape == qt.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,softcap,g,rep,dtype", DECODE_CASES)
def test_gqa_decode_matches_jax(window, softcap, g, rep, dtype):
    b, d, T = 2, 16, 64
    (qj, kj, vj), (qt, kt, vt) = _inputs(g * 10 + rep, (b, g, rep, d), T, b,
                                         g, d, dtype)
    for length in (1, 33, 64):
        want = jax_gqa.gqa_flash_decode(qj, kj, vj, length, 0.25,
                                        window=window, softcap=softcap,
                                        block_t=32)
        got = gqa_decode.gqa_flash_decode(qt, kt, vt, length, 0.25,
                                          window=window, softcap=softcap)
        assert got.dtype == torch.float32 and got.shape == qt.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_decode_is_the_last_row_of_a_window():
    """One decode step at length L equals the window attention of a
    one-position chunk at start L - 1 (the two kernels share a body)."""
    (_, _, _), (qt, kt, vt) = _inputs(3, (1, 2, 2, 4, 16), 40, 2, 2, 16,
                                      "float32")
    a = fused_cc.window_attention(qt, kt, vt, 20, 0.3, window=9)
    b = gqa_decode.gqa_flash_decode(qt[0], kt, vt, 21, 0.3, window=9)
    torch.testing.assert_close(a[0], b, rtol=1e-6, atol=1e-6)


def test_non_cpu_non_cuda_tensors_raise():
    q = torch.empty(4, 2, 2, 2, 16, device="meta")
    k = torch.empty(32, 2, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused_cc.window_attention(q, k, k, 0, 0.25)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        gqa_decode.gqa_flash_decode(q[0], k, k, 1, 0.25)


LAYER_KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
                num_query_groups=2, ffn_hidden_size=96, vocab_size=256,
                max_position_embeddings=32, normalization="rmsnorm",
                position_embedding_type="rope", activation="swiglu")


def _layer_matches_jax(kw_jax, kw_port, dtype, rtol, atol):
    """A prompt chunk (window kernel) and then two single-token steps
    (decode kernel) through one layer, with the same weights and
    positions on both sides; outputs and cached keys compared."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jcfg = JaxConfig(**kw_jax, compute_dtype=jdt, use_flash_attention=False)
    tcfg = TransformerConfig(**kw_port, compute_dtype=tdt)
    layer_j = JaxLayer(jcfg, decode=True)
    rng = np.random.RandomState(17)
    b, plen = 2, 6
    x0 = rng.randn(plen, b, 64).astype(np.float32)
    variables = layer_j.init(jax.random.PRNGKey(1),
                             jnp.asarray(x0, jdt))
    params = jax.tree.map(np.asarray, variables["params"])
    params_j = jax.tree.map(jnp.asarray, params)
    cache_j = variables["cache"]

    layer_t = ParallelTransformerLayer(tcfg, device="cpu")
    layer_t.load_state_dict(from_jax_params(params))
    cache_t = KVCache(1, 32, b, tcfg.query_groups, tcfg.kv_channels, tdt,
                      "cpu")

    chunks = [x0] + [rng.randn(1, b, 64).astype(np.float32)
                     for _ in range(2)]
    pos = 0
    for x in chunks:
        s = x.shape[0]
        positions = np.broadcast_to(pos + np.arange(s)[:, None], (s, b))
        want, mut = layer_j.apply({"params": params_j, "cache": cache_j},
                                  jnp.asarray(x, jdt), None,
                                  jnp.asarray(positions), mutable=["cache"])
        cache_j = mut["cache"]
        with torch.no_grad():
            got = layer_t(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(positions.copy()), cache_t)
        cache_t.advance(s)
        pos += s
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(
            cache_t.keys[0][:pos].float().numpy(),
            np.asarray(cache_j["self_attention"]["cached_key"][:pos]
                       .astype(jnp.float32)), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5),
                                             ("bfloat16", 2e-2, 2e-2)])
@pytest.mark.parametrize("window", [None, 3])
def test_transformer_layer_decode_matches_jax(dtype, rtol, atol, window):
    kw = dict(LAYER_KW, sliding_window=window)
    _layer_matches_jax(kw, kw, dtype, rtol, atol)


LLAMA3_SCALING = dict(rope_type="llama3", factor=4.0, low_freq_factor=1.0,
                      high_freq_factor=4.0,
                      original_max_position_embeddings=16)
KNOBS = {
    # Llama-3.1 rope scaling, NeoX partial rotary, Gemma-2 softcap and
    # query scalar, a decoupled head dim
    "llama3-partial-softcap": dict(rope_scaling=LLAMA3_SCALING,
                                   rotary_percent=0.5,
                                   attn_logit_softcapping=20.0,
                                   query_pre_attn_scalar=24.0,
                                   head_dim=32),
    # GPT-J interleaved rotary, linear scaling, geglu, multi-head KV
    "interleaved-linear-geglu": dict(
        rotary_interleaved=True, activation="geglu", num_query_groups=None,
        rope_scaling=dict(rope_type="linear", factor=2.0)),
    # biased gelu MLP, every 2nd layer full attention (layer 0 windowed)
    "gelu-window-pattern": dict(activation="gelu", sliding_window=2,
                                sliding_window_pattern=2),
    "relu2": dict(activation="relu2"),
}


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_transformer_layer_knobs_match_jax(knobs):
    """The decode path's other config knobs, in fp32 (1e-4 as above)."""
    extra = dict(KNOBS[knobs])
    scaling = extra.pop("rope_scaling", None)
    kw_jax = dict(LAYER_KW, **extra)
    kw_port = dict(LAYER_KW, **extra)
    if scaling is not None:
        kw_jax["rope_scaling"] = JaxRopeScaling(**scaling)
        kw_port["rope_scaling"] = RopeScaling(**scaling)
    _layer_matches_jax(kw_jax, kw_port, "float32", 1e-4, 1e-5)
