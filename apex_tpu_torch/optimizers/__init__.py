"""Fused optimizers."""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedAdam", "FusedLAMB", "FusedMixedPrecisionLamb", "FusedSGD"]
