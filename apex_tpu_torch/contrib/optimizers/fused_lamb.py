"""Deprecated contrib FusedLAMB (reference ``apex/contrib/optimizers/
fused_lamb.py``): warns and defers to
:class:`apex_tpu_torch.optimizers.FusedLAMB`."""

import warnings

from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB as _FusedLAMB


class FusedLAMB(_FusedLAMB):
    def __init__(self, *args, **kwargs):
        warnings.warn(
            "apex_tpu_torch.contrib.optimizers.FusedLAMB is deprecated; use "
            "apex_tpu_torch.optimizers.FusedLAMB", DeprecationWarning,
            stacklevel=2)
        super().__init__(*args, **kwargs)
