"""Transformer building blocks: the model-parallel grid
(``parallel_state``), tensor-parallel layers (``tensor_parallel``), fused
softmax, and mixture of experts (``moe``)."""

from apex_tpu_torch.transformer import moe, parallel_state, tensor_parallel

__all__ = ["moe", "parallel_state", "tensor_parallel"]
