"""Decoder LMs and KV-cache generation."""

from apex_tpu_torch.models.generation import (
    decode_step,
    filter_logits,
    generate,
    init_cache,
    prefill,
    sample_logits,
)
from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.models.kv_cache import KVCache
from apex_tpu_torch.models.params import from_jax_params, init_weights
from apex_tpu_torch.models.transformer_lm import RopeScaling, TransformerConfig

__all__ = [
    "GPTModel", "KVCache", "RopeScaling", "TransformerConfig",
    "decode_step", "filter_logits", "from_jax_params", "generate",
    "init_cache", "init_weights", "prefill", "sample_logits",
]
