"""Deprecated contrib FusedSGD (reference ``apex/contrib/optimizers/
fused_sgd.py``): warns and defers to
:class:`apex_tpu_torch.optimizers.FusedSGD`."""

import warnings

from apex_tpu_torch.optimizers.fused_sgd import FusedSGD as _FusedSGD


class FusedSGD(_FusedSGD):
    def __init__(self, *args, **kwargs):
        warnings.warn(
            "apex_tpu_torch.contrib.optimizers.FusedSGD is deprecated; use "
            "apex_tpu_torch.optimizers.FusedSGD", DeprecationWarning,
            stacklevel=2)
        super().__init__(*args, **kwargs)
