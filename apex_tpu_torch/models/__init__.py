"""Decoder LMs, BERT and the DeepSeek MLA model: KV-cache and
latent-cache generation, at tp = 1 and tensor-parallel, and the training
step's models and losses."""

from apex_tpu_torch.models.bert import BertModel, bert_loss_fn
from apex_tpu_torch.models.generation import (
    beam_search,
    decode_step,
    filter_logits,
    generate,
    init_cache,
    init_params_tp,
    prefill,
    prefill_prefix,
    sample_logits,
    speculative_generate,
    tensor_parallel_beam_search,
    tensor_parallel_generate,
    verify_step,
)
from apex_tpu_torch.models.gpt import GPTModel, gpt_loss_fn
from apex_tpu_torch.models.kv_cache import KVCache
from apex_tpu_torch.models.mla import (
    DeepseekModel,
    MLACache,
    MLAConfig,
    mla_cached_generate,
    mla_greedy_generate,
)
from apex_tpu_torch.models.params import (
    from_jax_params,
    from_jax_segments,
    init_weights,
    load_jax_optimizer_state,
    rank_state_dict,
)
from apex_tpu_torch.models.tp_split import (
    split_mla_params_for_tp,
    split_params_for_tp,
)
from apex_tpu_torch.models.transformer_lm import RopeScaling, TransformerConfig

__all__ = [
    "BertModel", "DeepseekModel", "GPTModel", "KVCache", "MLACache",
    "MLAConfig", "RopeScaling", "TransformerConfig", "beam_search",
    "bert_loss_fn", "decode_step", "filter_logits", "from_jax_params",
    "from_jax_segments", "generate", "gpt_loss_fn", "init_cache",
    "init_params_tp", "init_weights", "load_jax_optimizer_state",
    "mla_cached_generate", "mla_greedy_generate", "prefill",
    "prefill_prefix", "rank_state_dict", "sample_logits",
    "speculative_generate", "split_mla_params_for_tp",
    "split_params_for_tp", "tensor_parallel_beam_search",
    "tensor_parallel_generate", "verify_step",
]
