"""Fused optimizers."""

from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedAdagrad", "FusedAdam", "FusedLAMB",
           "FusedMixedPrecisionLamb", "FusedNovoGrad", "FusedSGD"]
