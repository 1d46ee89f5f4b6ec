"""Split a tp = 1 ``GPTModel``, ``BertModel`` or ``DeepseekModel``
``state_dict`` into the per-rank tensor-parallel layout.

Counterpart of ``apex_tpu/models/tp_split.py`` ``split_params_for_tp``
and ``split_mla_params_for_tp``, on the port's ``state_dict`` (the JAX tree's names joined with ".", as
:func:`~apex_tpu_torch.models.params.from_jax_params` carries it). Each
entry becomes a stacked [tp, ...] tensor, rank r's shard at index r, by
the rules of the JAX function:

- ``query_key_value``: MHA lays its columns out per head as [q|k|v], so a
  contiguous split is per-head right; GQA lays out [all q heads |
  per-group k|v], so rank r takes its block of q heads AND its block of
  kv groups (a two-region split).
- ``dense_h_to_4h``: gelu splits its columns; swiglu/geglu are fused
  [gate | up], so each half splits on its own (two regions).
- ``dense`` of ``self_attention`` and ``dense_4h_to_h`` (row-parallel):
  the input dim (second to last) of the weight; their biases replicate
  (added once after the all-reduce).
- ``word_embeddings``: vocabulary rows; ``lm_head``: vocabulary columns.
- everything else (layer norms, position embeddings, BERT's token-type
  table and its MLM, pooler and binary heads, which touch only the
  replicated hidden width) replicates; any other matrix raises rather
  than being replicated silently.

:func:`split_mla_params_for_tp` splits a dense ``DeepseekModel`` by
JAX's MLA rules (module doc there); its routed experts raise, as MoE at
tp > 1 is expert parallelism's (ROADMAP queue A item 6).
"""

import torch

# modules whose matrices replicate across the tp ranks
_REPLICATED_MODULES = frozenset({
    "position_embeddings", "input_layernorm", "post_attention_layernorm",
    "final_layernorm", "patch_embed", "cls_token", "classifier",
    # BertModel: the heads below the vocabulary projection
    "tokentype_embeddings", "lm_dense", "lm_layernorm", "pooler",
    "binary_head",
})


def _split_contiguous(x, tp, axis):
    return torch.stack(torch.chunk(x, tp, dim=axis))


def _split_two_region(x, tp, size_a, axis):
    """Split [region_a | region_b] along ``axis``: rank r gets its 1/tp
    slice of each region, concatenated."""
    a, b = torch.split(x, [size_a, x.shape[axis] - size_a], dim=axis)
    a_shards = torch.chunk(a, tp, dim=axis)
    b_shards = torch.chunk(b, tp, dim=axis)
    return torch.stack([torch.cat([a_shards[r], b_shards[r]], dim=axis)
                        for r in range(tp)])


def _replicate(x, tp):
    return x[None].expand((tp,) + tuple(x.shape)).clone()


def _dense_tp_rule(cfg, tp):
    heads, groups = cfg.num_attention_heads, cfg.query_groups
    kv = cfg.kv_channels
    for name, n in (("num_attention_heads", heads),
                    ("query_groups", groups), ("ffn_size", cfg.ffn_size)):
        if n % tp:
            raise ValueError(f"{name} ({n}) is not divisible by tp ({tp})")

    def rule(key, leaf):
        names = set(key.split("."))
        if (names & {"word_embeddings", "lm_head", "lm_head_bias"}
                and cfg.vocab_size % tp):
            raise ValueError(f"vocab_size ({cfg.vocab_size}) is not "
                             f"divisible by tp ({tp})")
        if "query_key_value" in names:
            if groups == heads:
                return _split_contiguous(leaf, tp, -1)
            return _split_two_region(leaf, tp, heads * kv, -1)
        if "dense_h_to_4h" in names:
            if cfg.activation in ("swiglu", "geglu"):
                return _split_two_region(leaf, tp, cfg.ffn_size, -1)
            return _split_contiguous(leaf, tp, -1)
        if ("dense_4h_to_h" in names
                or ("dense" in names and "self_attention" in names)):
            if leaf.dim() >= 2 and "weight" in names:
                return _split_contiguous(leaf, tp, -2)
            return _replicate(leaf, tp)  # row bias: added once post-reduce
        if "word_embeddings" in names:
            return _split_contiguous(leaf, tp, -2)
        if "lm_head" in names or "lm_head_bias" in names:
            return _split_contiguous(leaf, tp, -1)
        if leaf.dim() >= 2 and not (names & _REPLICATED_MODULES):
            raise ValueError(
                f"split_params_for_tp: unrecognized weight matrix at {key} "
                f"(shape {tuple(leaf.shape)}); refusing to replicate it "
                f"silently; add a split rule")
        return _replicate(leaf, tp)

    return rule


def split_params_for_tp(cfg, state_dict, tp: int):
    """``{name: [tp, ...]}`` for a tp = 1 ``GPTModel`` ``state_dict`` and
    its :class:`~apex_tpu_torch.models.TransformerConfig` (see the module
    doc). Raises where heads, groups, ffn or vocabulary do not divide by
    ``tp``, and for MoE configurations."""
    if getattr(cfg, "num_moe_experts", None):
        raise ValueError(
            "split_params_for_tp handles dense GPT checkpoints only; MoE "
            "expert and router weights need the expert-parallel layout "
            "(ROADMAP queue A item 6), not a tp split")
    if tp == 1:
        return {k: v[None].clone() for k, v in state_dict.items()}
    rule = _dense_tp_rule(cfg, tp)
    return {k: rule(k, v) for k, v in state_dict.items()}


# -- MLA / DeepSeek family ---------------------------------------------------

_MLA_COLUMN = frozenset({"q_b", "kv_b"})  # per-head expansions
_MLA_ROW = frozenset({"o", "down"})
_MLA_REPLICATED = frozenset({
    "q_a", "kv_a",            # the shared latent projections
    "q_a_norm", "kv_a_norm", "input_norm", "post_attn_norm", "final_norm",
})


def split_mla_params_for_tp(cfg, state_dict, tp: int):
    """``{name: [tp, ...]}`` for a tp = 1 dense ``DeepseekModel``
    ``state_dict`` and its :class:`~apex_tpu_torch.models.MLAConfig`, by
    JAX's rules: ``q_b`` and ``kv_b`` split their columns (whole heads),
    ``o`` and ``down`` their rows, ``gate_up`` two regions at its
    midpoint, ``embed_tokens`` its vocabulary rows and ``lm_head`` its
    vocabulary columns; the latent projections and the norms replicate.
    Raises where heads, ffn or vocabulary do not divide by ``tp``, on a
    matrix it has no rule for, and on routed-expert leaves (the router
    and experts of a MoE layer: ROADMAP queue A item 6)."""
    for name, n in (("num_heads", cfg.num_heads),
                    ("ffn_hidden_size", cfg.ffn_hidden_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{name} ({n}) is not divisible by tp ({tp})")
    if tp == 1:
        return {k: v[None].clone() for k, v in state_dict.items()}

    def rule(key, leaf):
        names = set(key.split("."))
        if names & {"experts", "router", "gate_weight"}:
            raise NotImplementedError(
                f"split_mla_params_for_tp: {key} belongs to a routed "
                f"mixture-of-experts layer; MoE at tp > 1 is expert "
                f"parallelism's (ROADMAP queue A item 6)")
        if "gate_up" in names:
            half = leaf.shape[-1] // 2
            if leaf.shape[-1] % 2 or half % tp:
                raise ValueError(
                    f"split_mla_params_for_tp: packed [gate | up] leaf at "
                    f"{key} (shape {tuple(leaf.shape)}) has half-width "
                    f"{half}, not divisible by tp ({tp})")
            return _split_two_region(leaf, tp, half, -1)
        if names & _MLA_COLUMN:
            return _split_contiguous(leaf, tp, -1)
        if names & _MLA_ROW:
            return _split_contiguous(leaf, tp, -2)
        if "embed_tokens" in names:
            return _split_contiguous(leaf, tp, -2)
        if "lm_head" in names:
            return _split_contiguous(leaf, tp, -1)
        if leaf.dim() >= 2 and not (names & _MLA_REPLICATED):
            raise ValueError(
                f"split_mla_params_for_tp: unrecognized weight matrix at "
                f"{key} (shape {tuple(leaf.shape)})")
        return _replicate(leaf, tp)

    return {k: rule(k, v) for k, v in state_dict.items()}
