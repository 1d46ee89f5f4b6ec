"""Transformer building blocks: tensor-parallel layers at world size 1,
fused softmax, and mixture of experts (``moe``)."""

from apex_tpu_torch.transformer import moe

__all__ = ["moe"]
