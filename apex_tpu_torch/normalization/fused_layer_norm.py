"""RMSNorm module (counterpart of ``apex_tpu.normalization.FusedRMSNorm``)."""

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import rms_norm


class FusedRMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` dims with an fp32
    weight (initialised to ones)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(self.normalized_shape,
                                               dtype=torch.float32,
                                               device=device))
                       if elementwise_affine else None)

    def forward(self, x, out_dtype=None):
        """Normalize ``x`` in fp32; the result is rounded to x's dtype and
        then to ``out_dtype`` (default: x's dtype)."""
        return rms_norm(x, self.normalized_shape, self.weight, self.eps,
                        out_dtype)

    def extra_repr(self):
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.weight is not None}")

