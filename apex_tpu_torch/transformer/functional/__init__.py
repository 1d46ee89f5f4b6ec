"""Fused functional ops of the transformer."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    scaled_upper_triang_masked_softmax,
)

__all__ = ["scaled_upper_triang_masked_softmax"]
