"""Normalization modules."""

from apex_tpu_torch.normalization.fused_layer_norm import FusedRMSNorm

__all__ = ["FusedRMSNorm"]
