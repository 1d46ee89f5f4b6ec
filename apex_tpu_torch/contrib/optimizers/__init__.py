"""The ZeRO optimizers: :class:`DistributedFusedAdam` and
:class:`DistributedFusedLAMB` (counterpart of
``apex_tpu/contrib/optimizers``). The deprecated set there
(``FusedAdam``, ``FusedLAMB``, ``FusedSGD``, ``FP16_Optimizer``) comes
with ROADMAP item 4."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (
    DistributedFusedLAMB,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB"]
