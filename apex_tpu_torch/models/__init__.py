"""Decoder LMs: KV-cache generation and the training step's model and
loss."""

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
    load_jax_adam_state,
)
from apex_tpu_torch.models.transformer_lm import RopeScaling, TransformerConfig

__all__ = [
    "GPTModel", "KVCache", "RopeScaling", "TransformerConfig",
    "decode_step", "filter_logits", "from_jax_params", "generate",
    "gpt_loss_fn", "init_cache", "init_weights", "load_jax_adam_state",
    "prefill", "sample_logits",
]
