"""Deprecated contrib FusedAdam (reference ``apex/contrib/optimizers/
fused_adam.py``, an older FusedAdam kept for backward compatibility):
warns and defers to :class:`apex_tpu_torch.optimizers.FusedAdam`, as
``apex_tpu.contrib.optimizers.FusedAdam`` does. The old contrib keyword
arguments ``use_mt`` and ``amp_scale_adjustment`` are accepted and
dropped."""

import warnings

from apex_tpu_torch.optimizers.fused_adam import FusedAdam as _FusedAdam


class FusedAdam(_FusedAdam):
    def __init__(self, *args, **kwargs):
        warnings.warn(
            "apex_tpu_torch.contrib.optimizers.FusedAdam is deprecated; use "
            "apex_tpu_torch.optimizers.FusedAdam", DeprecationWarning,
            stacklevel=2)
        kwargs.pop("use_mt", None)
        kwargs.pop("amp_scale_adjustment", None)
        super().__init__(*args, **kwargs)
