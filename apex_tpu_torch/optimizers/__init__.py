"""Fused optimizers."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam

__all__ = ["FusedAdam"]
