"""Deprecated contrib FP16_Optimizer (reference ``apex/contrib/
optimizers/fp16_optimizer.py``): warns and defers to
:class:`apex_tpu_torch.fp16_utils.FP16_Optimizer`."""

import warnings

from apex_tpu_torch.fp16_utils.fp16_optimizer import (
    FP16_Optimizer as _FP16_Optimizer,
)


class FP16_Optimizer(_FP16_Optimizer):
    def __init__(self, *args, **kwargs):
        warnings.warn(
            "apex_tpu_torch.contrib.optimizers.FP16_Optimizer is deprecated; "
            "use apex_tpu_torch.fp16_utils.FP16_Optimizer",
            DeprecationWarning, stacklevel=2)
        super().__init__(*args, **kwargs)
