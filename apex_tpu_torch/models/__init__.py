"""Decoder LMs and BERT: KV-cache generation and the training step's
models and losses."""

from apex_tpu_torch.models.bert import BertModel, bert_loss_fn
from apex_tpu_torch.models.generation import (
    decode_step,
    filter_logits,
    generate,
    init_cache,
    prefill,
    sample_logits,
)
from apex_tpu_torch.models.gpt import GPTModel, gpt_loss_fn
from apex_tpu_torch.models.kv_cache import KVCache
from apex_tpu_torch.models.params import (
    from_jax_params,
    init_weights,
    load_jax_optimizer_state,
)
from apex_tpu_torch.models.transformer_lm import RopeScaling, TransformerConfig

__all__ = [
    "BertModel", "GPTModel", "KVCache", "RopeScaling", "TransformerConfig",
    "bert_loss_fn", "decode_step", "filter_logits", "from_jax_params",
    "generate", "gpt_loss_fn", "init_cache", "init_weights",
    "load_jax_optimizer_state", "prefill", "sample_logits",
]
