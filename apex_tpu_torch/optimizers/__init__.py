"""Fused optimizers."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB

__all__ = ["FusedAdam", "FusedLAMB"]
