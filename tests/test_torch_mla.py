"""apex_tpu_torch.models.mla (MLAConfig, DeepseekModel in train, prefill
and step mode, the latent cache, mla_greedy_generate and
mla_cached_generate) against apex_tpu.models.mla on the CPU.

The JAX model's parameters are carried across with
``from_jax_params``. Tiny configs: a dense one, a MoE one
(first layer dense, then 8 routed experts top-2 and a shared expert) and
one with a q latent. The single-token step runs on both branches: over
a 32-row cache (a tile divides it: JAX's Pallas kernel in interpret
mode, the port's plain version of the kernel) and over a 600-row cache
(no tile divides it: both models' einsum branch). Inputs come from
numpy seeds.

Tolerances (logits of std ~0.1): fp32 within 1e-5 (fp32 sums in another
order; measured at most 6e-7). bf16 against JAX run op by op
(``model.apply`` without ``jax.jit``, which would keep excess precision
across the bf16 round trips) within 1e-4: both round the same bf16
values at the same places (measured at most 3e-8, the fp32 head's sums
in another order); a bf16 activation rounded the other way would show
as ~1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import mla_decode as jax_md
from apex_tpu.models.mla import DeepseekModel as JaxDeepseekModel
from apex_tpu.models.mla import MLAConfig as JaxMLAConfig
from apex_tpu.models.mla import mla_cached_generate as jax_cached_generate
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.models import (
    DeepseekModel,
    MLAConfig,
    from_jax_params,
    mla_cached_generate,
    mla_greedy_generate,
)
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8, ffn_hidden_size=48,
            max_decode_length=32)
MOE = dict(TINY, num_layers=3, n_routed_experts=8, moe_intermediate_size=16,
           n_shared_experts=2, moe_top_k=2, first_k_dense_replace=1,
           routed_scaling_factor=1.5)
QLORA = dict(TINY, q_lora_rank=12)
CONFIGS = {"dense": TINY, "moe": MOE, "q_lora": QLORA}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-4)}


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    jax_md.force_interpret(True)
    yield
    jax_md.force_interpret(False)


def _models(fields, dtype, **over):
    jd, td, _ = DTYPES[dtype]
    fields = dict(fields, **over)
    jm = JaxDeepseekModel(JaxMLAConfig(**fields, compute_dtype=jd))
    tokens = np.random.RandomState(3).randint(0, 64, (2, 6))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = MLAConfig(**fields, compute_dtype=td)
    tm = DeepseekModel(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(params, cfg))
    return jm, params, tm, tokens


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["dense", "moe", "q_lora"])
def test_train_mode_logits_match_jax(name, dtype):
    jm, params, tm, tokens = _models(CONFIGS[name], dtype)
    want = jm.apply({"params": params}, jnp.asarray(tokens))
    got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 6, 64)
    _close(got, want, dtype)


@pytest.mark.parametrize("max_len", [32, 600])  # kernel / einsum branch
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["dense", "moe", "q_lora"])
def test_prefill_and_steps_match_jax(name, dtype, max_len):
    jm, params, tm, tokens = _models(CONFIGS[name], dtype,
                                     max_decode_length=max_len)
    want, var = jm.apply({"params": params}, jnp.asarray(tokens),
                         mode="prefill", mutable=["cache"])
    got, cache = tm.decode_prefill(torch.from_numpy(tokens))
    _close(got, want, dtype)
    for _ in range(3):  # feed JAX's greedy tokens to both
        nxt = np.argmax(np.asarray(want, np.float32)[:, -1:], -1)
        want, var = jm.apply({"params": params, "cache": var["cache"]},
                             jnp.asarray(nxt), mode="step",
                             mutable=["cache"])
        got, cache = tm.decode_step(torch.from_numpy(nxt), cache)
        _close(got, want, dtype)
    lat_cache = var["cache"]["layer_0"]["self_attn"]["latent"]
    _close(cache.latent[0], lat_cache, dtype)
    assert cache.pos == 6 + 3


def test_kernel_branch_is_taken_exactly_where_a_tile_divides(monkeypatch):
    """The step over a 32-row cache goes through mla_flash_decode, once
    a layer; over a 600-row cache it does not."""
    from apex_tpu_torch.contrib import mla_decode

    calls = []
    real = mla_decode.mla_flash_decode
    monkeypatch.setattr(mla_decode, "mla_flash_decode",
                        lambda *a: calls.append(a[2]) or real(*a))
    for max_len, want in ((32, [7, 7]), (600, [])):
        calls.clear()
        _, _, tm, tokens = _models(TINY, "float32", max_decode_length=max_len)
        _, cache = tm.decode_prefill(torch.from_numpy(tokens))
        tm.decode_step(torch.from_numpy(tokens[:, :1]), cache)
        assert calls == want  # live length pos + 1 in each layer


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_cached_generate_is_token_exact_fp32(name):
    jm, params, tm, tokens = _models(CONFIGS[name], "float32")
    want = jax_cached_generate(jm, params, jnp.asarray(tokens), 8)
    got = mla_cached_generate(tm, torch.from_numpy(tokens), 8)
    oracle = mla_greedy_generate(tm, torch.from_numpy(tokens), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())


def test_cached_generate_edges():
    _, _, tm, tokens = _models(TINY, "float32")
    prompt = torch.from_numpy(tokens)
    torch.testing.assert_close(mla_cached_generate(tm, prompt, 0), prompt)
    one = mla_cached_generate(tm, prompt, 1)
    assert torch.equal(one, mla_greedy_generate(tm, prompt, 1))
    with pytest.raises(ValueError, match="exceeds max_decode_length"):
        mla_cached_generate(tm, prompt, 32 - 6 + 1)
    assert mla_cached_generate(tm, prompt, 32 - 6).shape == (2, 32)


def test_config_defaults_match_jax():
    jax_fields = {f.name: getattr(JaxMLAConfig(), f.name)
                  for f in dataclasses.fields(JaxMLAConfig)}
    port = MLAConfig()
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    assert {f.name for f in dataclasses.fields(MLAConfig)} == set(jax_fields)
    for name, value in jax_fields.items():
        want = dtypes.get(value, value) if name.endswith("dtype") else value
        assert getattr(port, name) == want, name
    assert port.qk_head_dim == JaxMLAConfig().qk_head_dim


def test_einsum_dispatch_is_refused_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 6"):
        MLAConfig(moe_dispatch_mode="einsum")


@pytest.mark.parametrize("name", ["dense", "moe", "q_lora"])
def test_parameters_keep_the_jax_names_and_shapes(name):
    _, params, tm, _ = _models(CONFIGS[name], "float32")
    state = from_jax_params(params)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in tm.state_dict().items()}
    if name == "moe":
        assert "layers.1.mlp.experts.w1" in state
        assert "layers.0.mlp.gate_up.weight" in state
        assert "layers.2.shared_mlp.down.weight" in state
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(params, MLAConfig(
            **dict(CONFIGS[name], num_layers=5)))


def test_init_weights_draws_every_parameter_on_the_device_dtype():
    from apex_tpu_torch.models import init_weights

    cfg = MLAConfig(**MOE, params_dtype=torch.bfloat16)
    tm = DeepseekModel(cfg, device="cpu")
    init_weights(tm, 0)
    for name, p in tm.named_parameters():  # norm weights stay fp32
        want = torch.float32 if name.endswith("norm.weight") else torch.bfloat16
        assert p.dtype == want and torch.isfinite(p).all(), name
    assert torch.all(tm.layers[0].input_norm.weight == 1)
    w1 = tm.layers[1].mlp.experts.w1.float()
    assert abs(w1.std().item() - 32 ** -0.5) < 0.02  # fan-in per expert
