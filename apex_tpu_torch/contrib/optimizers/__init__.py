"""The ZeRO optimizers, :class:`DistributedFusedAdam` and
:class:`DistributedFusedLAMB`, and the deprecated set kept for backward
compatibility (``FusedAdam``, ``FusedLAMB``, ``FusedSGD``,
``FP16_Optimizer``: each warns and defers to its counterpart in
:mod:`apex_tpu_torch.optimizers` or :mod:`apex_tpu_torch.fp16_utils`).
Counterpart of ``apex_tpu/contrib/optimizers``."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (
    DistributedFusedLAMB,
)
from apex_tpu_torch.contrib.optimizers.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.contrib.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.contrib.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.contrib.optimizers.fused_sgd import FusedSGD

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB", "FP16_Optimizer",
           "FusedAdam", "FusedLAMB", "FusedSGD"]
