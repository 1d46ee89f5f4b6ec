"""apex_tpu_torch's tensor-parallel serving pieces that need no second
process, against apex_tpu's on the CPU: ``KVCacheSpec.
consolidate_host_rows`` at tp 2 and 4 (bf16 and int8, the last int8
block of each rank padded) on the same numpy rows as JAX's, with its
refusals; the canonical seed row template; the rank slice as the round
trip of consolidation; ``split_mla_params_for_tp`` on a tiny dense
DeepSeek tree, and ``rank_state_dict`` on JAX's stacked tree of it; and the engine's mesh refusals with JAX's messages.

The model is a 2-layer Llama-shaped GPT (hidden 48, 4 heads in 2 groups
of head dim 12, vocab 96, 16 positions), bf16 compute; its int8 store
quantizes each position's 24 lanes in blocks of 16, so each rank's
second block holds 8 lanes of zero pad.

Tolerances: consolidated rows, templates and split trees are compared
exactly (the same fp32 products rounded to bf16 once); the int8 round
trip of a rank slice is held per lane to half a grid step of its
block's absmax (absmax / 254) plus half a bf16 step of it (absmax *
2**-8), the rounding of the dequantized value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.mla import DeepseekModel as JaxDeepseekModel
from apex_tpu.models.mla import MLAConfig as JaxMLAConfig
from apex_tpu.models.tp_split import (
    split_mla_params_for_tp as jax_split_mla,
)
from apex_tpu.serving import KVCacheSpec as JaxKVCacheSpec
from apex_tpu.serving import ServeConfig as JaxServeConfig
from apex_tpu.serving import ServeEngine as JaxServeEngine
from apex_tpu.transformer import parallel_state as jax_ps
from apex_tpu_torch.models import (
    GPTModel,
    MLAConfig,
    TransformerConfig,
    from_jax_params,
    rank_state_dict,
    split_mla_params_for_tp,
)
from apex_tpu_torch.parallel import compression
from apex_tpu_torch.serving import KVCacheSpec, ServeConfig, ServeEngine, ServeMesh
from apex_tpu_torch.serving import engine as engine_mod
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(hidden_size=48, num_layers=2, num_attention_heads=4,
          num_query_groups=2, vocab_size=96, max_position_embeddings=16,
          normalization="rmsnorm", position_embedding_type="rope",
          activation="swiglu")
BLOCK = 16
MLA = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=8,
           qk_rope_head_dim=4, v_head_dim=8, ffn_hidden_size=48,
           max_decode_length=32)


@pytest.fixture(autouse=True)
def _no_grid():
    jax_ps.destroy_model_parallel()
    yield
    jax_ps.destroy_model_parallel()


@functools.lru_cache(maxsize=None)
def _jax_model():
    return JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.bfloat16,
                                 use_flash_attention=False), decode=True)


@functools.lru_cache(maxsize=None)
def _port_model():
    return GPTModel(TransformerConfig(**KW, compute_dtype=torch.bfloat16),
                    device="cpu")


def _specs(mode):
    return (JaxKVCacheSpec(_jax_model(), 4, mode=mode, block_size=BLOCK),
            KVCacheSpec(_port_model(), 4, mode=mode, block_size=BLOCK))


def _global_rows(mode, tp, seed):
    """One slot's store rows in JAX's global view for a ``tp``-rank
    engine whose per-rank layout is the tp = 1 model's (as a spec built
    at tp = 1 reads them): numpy, per layer K and V, and a level of 9."""
    rng = np.random.RandomState(seed)
    T, g, d = 16, 2, 12
    out = []
    for _ in range(2 * KW["num_layers"]):
        if mode == "int8":
            q = rng.randint(-127, 128, (T, tp * 2, BLOCK)).astype(np.int8)
            s = (rng.rand(T, tp * 2, 1) * 0.05).astype(np.float32)
            out.append({"q": q, "scale": s})
        else:
            out.append(rng.randn(T, 1, tp * g, d).astype(jnp.bfloat16))
    return out


def _jax_tree(leaves):
    L = KW["num_layers"]
    return {"transformer": {f"layer_{i}": {"self_attention": {
        "cache_index": np.int32(9), "cached_key": leaves[i],
        "cached_value": leaves[L + i]}} for i in range(L)}}


def _port_tree(leaves):
    L = KW["num_layers"]

    def leaf(x):
        if isinstance(x, dict):  # the port's store keeps the slot axis
            return {k: torch.from_numpy(v[:, None].copy())
                    for k, v in x.items()}
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)

    return {"keys": [leaf(x) for x in leaves[:L]],
            "values": [leaf(x) for x in leaves[L:]],
            "lengths": torch.tensor([9], dtype=torch.int32)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_consolidate_host_rows_matches_jax_bit_for_bit(mode, tp):
    jspec, pspec = _specs(mode)
    leaves = _global_rows(mode, tp, seed=tp)
    want = jspec.consolidate_host_rows(_jax_tree(leaves), tp=tp)
    got = pspec.consolidate_host_rows(_port_tree(leaves), tp=tp)
    assert got["lengths"].tolist() == [9]
    L = KW["num_layers"]
    for i in range(L):
        attn = want["transformer"][f"layer_{i}"]["self_attention"]
        for name, key in (("keys", "cached_key"), ("values", "cached_value")):
            w = np.asarray(attn[key]).astype(np.float32)
            g = got[name][i]
            assert g.dtype == torch.bfloat16
            assert tuple(g.shape) == w.shape == (16, 1, tp * 2, 12)
            np.testing.assert_array_equal(g.float().numpy(), w)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_consolidate_host_rows_refuses_other_layouts_as_jax(mode):
    jspec, pspec = _specs(mode)
    leaves = _global_rows(mode, 2, seed=0)
    # rows of a tp = 2 engine read as a tp = 4 one's
    with pytest.raises(ValueError, match="tp=4"):
        jspec.consolidate_host_rows(_jax_tree(leaves), tp=4)
    with pytest.raises(ValueError, match="tp=4"):
        pspec.consolidate_host_rows(_port_tree(leaves), tp=4)
    bad = _port_tree(leaves)
    if mode == "int8":
        bad["keys"][0] = bad["keys"][0]["q"]  # no scales
        with pytest.raises(ValueError, match="q/scale"):
            pspec.consolidate_host_rows(bad, tp=2)
        bad = _port_tree(leaves)
        bad["values"][1]["q"] = bad["values"][1]["q"].to(torch.int16)
    else:
        bad["values"][1] = bad["values"][1].float()
    with pytest.raises(ValueError, match="tp=2"):
        pspec.consolidate_host_rows(bad, tp=2)


def test_seed_row_template_is_canonical_as_jax():
    """A tp = 2 spec's raw rows hold every group, as JAX's
    ``host_zero_row(tp=2)`` of a spec built under a tp = 2 grid."""
    jax_ps.initialize_model_parallel(tensor_model_parallel_size_=2,
                                     devices=jax.devices()[:2])
    jspec = JaxKVCacheSpec(
        JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.bfloat16,
                              use_flash_attention=False), decode=True), 4)
    want = jspec.host_zero_row(tp=2)
    for mode in ("bf16", "int8"):
        spec = KVCacheSpec(_port_model(), 4, mode=mode, tp=2, rank=1)
        assert spec.groups == 1 and spec.canonical_groups == 2
        got = spec.host_zero_row()
        for i in range(KW["num_layers"]):
            attn = want["transformer"][f"layer_{i}"]["self_attention"]
            for name, key in (("keys", "cached_key"),
                              ("values", "cached_value")):
                w = attn[key]
                assert tuple(got[name][i].shape) == w.shape
                assert str(got[name][i].dtype).endswith(str(w.dtype))
                assert not got[name][i].any()
        assert got["lengths"].tolist() == [0]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_rank_slices_consolidate_back_to_the_canonical_rows(mode, tp):
    """Each rank's slice of canonical raw rows, stored in its own layout
    and concatenated in rank order, consolidates back to the rows: the
    reshard and consolidate halves of a migration."""
    cfg = TransformerConfig(**dict(KW, num_attention_heads=8,
                                   num_query_groups=4),
                            compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cpu")
    rng = np.random.RandomState(7)
    raw = [torch.from_numpy(rng.randn(16, 1, 4, 6).astype(np.float32)
                            ).to(torch.bfloat16) for _ in range(4)]
    specs = [KVCacheSpec(model, 4, mode=mode, block_size=BLOCK, tp=tp,
                         rank=r) for r in range(tp)]

    def stored(spec, x):
        x = spec.rank_slice(x)
        if mode == "bf16":
            return x
        q, s = compression.quantize_rows_blockwise(
            x.reshape(16, 1, spec.width), spec.block)
        return {"q": q, "scale": s}

    def cat(parts):
        if mode == "bf16":
            return torch.cat(parts, dim=-2)
        return {k: torch.cat([p[k] for p in parts], dim=-2)
                for k in ("q", "scale")}

    rows = {"keys": [cat([stored(s, x) for s in specs]) for x in raw[:2]],
            "values": [cat([stored(s, x) for s in specs]) for x in raw[2:]],
            "lengths": torch.tensor([5], dtype=torch.int32)}
    back = specs[0].consolidate_host_rows(rows, tp=tp)
    assert tuple(back["keys"][0].shape) == (16, 1, 4, 6)
    for got, want in zip(back["keys"] + back["values"], raw):
        if mode == "bf16":
            assert torch.equal(got, want)
            continue
        # each rank's lanes within half a step of its own blocks' absmax
        w = want.float().reshape(16, tp, -1)
        absmax = w.abs().amax(-1, keepdim=True)
        err = (got.float().reshape(16, tp, -1) - w).abs()
        assert (err <= absmax / 254.0 + absmax * 2.0 ** -8).all()


@functools.lru_cache(maxsize=None)
def _jax_mla():
    jm = JaxDeepseekModel(JaxMLAConfig(**MLA, compute_dtype=jnp.float32))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    return jm, jax.tree.map(np.asarray, params)


def test_split_mla_params_for_tp_matches_jax():
    jm, params = _jax_mla()
    cfg = MLAConfig(**MLA, compute_dtype=torch.float32)
    state = from_jax_params(params, cfg)
    for tp in (1, 2):
        want = from_jax_params(jax.tree.map(
            np.asarray, jax_split_mla(jm.config, params, tp)))
        got = split_mla_params_for_tp(cfg, state, tp)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
    with pytest.raises(ValueError, match="num_heads"):
        split_mla_params_for_tp(cfg, state, 3)
    moe = MLAConfig(**dict(MLA, num_layers=2, n_routed_experts=4,
                           moe_intermediate_size=8, first_k_dense_replace=1),
                    compute_dtype=torch.float32)
    leaf = {"layers.1.mlp.experts.w1": torch.zeros(4, 32, 16)}
    with pytest.raises(NotImplementedError, match="item 6"):
        split_mla_params_for_tp(moe, leaf, 2)


def test_rank_state_dict_reads_jax_stacked_trees():
    """Each rank's ``state_dict`` from JAX's stacked tree (numpy leaves,
    JAX's names) equals the one from the port's split of the same
    weights, exactly; a rank past the stack raises."""
    jm, params = _jax_mla()
    cfg = MLAConfig(**MLA, compute_dtype=torch.float32)
    stacked = jax.tree.map(np.asarray, jax_split_mla(jm.config, params, 2))
    ported = split_mla_params_for_tp(cfg, from_jax_params(params, cfg), 2)
    for rank in (0, 1):
        got = rank_state_dict(stacked, rank)
        want = rank_state_dict(ported, rank)
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="rank 2"):
        rank_state_dict(stacked, 2)


def test_engine_mesh_refusals_match_jax(monkeypatch):
    """JAX's four refusals at tp = 2 (``tests/L0/test_serving.py:671-694``,
    the same messages), the port's with its grid's tp read as 2; and a
    slot-sharded mesh at tp = 1, which in PyTorch is the fleet."""
    from jax.sharding import Mesh

    jax_ps.initialize_model_parallel(tensor_model_parallel_size_=2,
                                     devices=jax.devices()[:2])
    jmodel = JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.float32,
                                   use_flash_attention=False), decode=True)
    jcfg = dict(batch_buckets=(2,), prefill_buckets=(8,), num_slots=4)
    devs = np.asarray(jax.devices()[:4])
    cases = [
        ("mesh", None, None, {}),
        ("data", Mesh(devs.reshape(2, 2), ("data", "tp")),
         ServeMesh(("data", "tp"), (2, 2)), {}),
        ("mesh axis 'tp'", Mesh(devs[:2].reshape(1, 2), ("data", "model")),
         ServeMesh(("data", "model"), (1, 2)), {}),
        ("hardwired", Mesh(devs[:2].reshape(1, 2), ("data", "tp")),
         ServeMesh(("data", "tp"), (1, 2)), dict(model_axis="model")),
    ]
    for match, jmesh, pmesh, kw in cases:
        with pytest.raises(ValueError, match=match):
            JaxServeEngine(jmodel, None, JaxServeConfig(**jcfg, **kw),
                           mesh=jmesh)
    jax_ps.destroy_model_parallel()
    model = _port_model()
    monkeypatch.setattr(engine_mod.parallel_state,
                        "get_tensor_model_parallel_world_size", lambda: 2)
    for match, jmesh, pmesh, kw in cases:
        with pytest.raises(ValueError, match=match):
            ServeEngine(model, ServeConfig(**jcfg, **kw), mesh=pmesh)
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="5\\(c\\)"):
        ServeEngine(model, ServeConfig(**jcfg),
                    mesh=ServeMesh(("data",), (2,)))
    with pytest.raises(TypeError, match="ServeMesh"):
        ServeEngine(model, ServeConfig(**jcfg), mesh=object())
    # the grid's own mesh at tp = 1 is one device: accepted
    eng = ServeEngine(model, ServeConfig(**jcfg), mesh=ServeMesh.from_grid())
    assert eng.tp == 1 and eng.spec.groups == 2
