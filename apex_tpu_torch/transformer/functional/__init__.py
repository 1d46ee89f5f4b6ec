"""Fused functional ops of the transformer."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    FusedScaleMaskSoftmax,
    GenericFusedScaleMaskSoftmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)

__all__ = ["FusedScaleMaskSoftmax", "GenericFusedScaleMaskSoftmax",
           "scaled_masked_softmax", "scaled_softmax",
           "scaled_upper_triang_masked_softmax"]
