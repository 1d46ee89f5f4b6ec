"""Normalization modules and functional entry points."""

from apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
    mixed_dtype_fused_layer_norm_affine,
)

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "fused_layer_norm", "fused_layer_norm_affine",
           "mixed_dtype_fused_layer_norm_affine"]
