"""Tensor parallelism on ``torch.distributed`` (counterpart of
``apex_tpu/transformer/tensor_parallel``): the region ops, the Megatron
layers, the vocab-parallel cross entropy, the named random streams and
checkpointing, the batch broadcast and the helpers."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    allreduce_sequence_parallel_grads,
    linear_with_grad_accumulation_and_async_allreduce,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    RNGStatesTracker,
    checkpoint,
    get_rng_state_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_rng_tracker_name,
    model_parallel_seed,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)

__all__ = [
    "ColumnParallelLinear", "RNGStatesTracker", "RowParallelLinear",
    "VocabParallelEmbedding", "VocabUtility",
    "allreduce_sequence_parallel_grads", "broadcast_data", "checkpoint",
    "copy_to_tensor_model_parallel_region", "divide",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region", "get_rng_state_tracker",
    "linear_with_grad_accumulation_and_async_allreduce",
    "model_parallel_cuda_manual_seed", "model_parallel_rng_tracker_name",
    "model_parallel_seed", "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "split_tensor_along_last_dim",
    "vocab_parallel_cross_entropy"]
