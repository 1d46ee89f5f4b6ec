"""LayerNorm and RMSNorm modules and functional entry points
(counterparts of ``apex_tpu/normalization/fused_layer_norm.py``).

The modules keep the JAX parameter names (``weight``, and LayerNorm's
``bias``), fp32 and initialised to ones and zeros. The "Mixed" variant
returns the parameters' dtype, as the reference's mixed-dtype kernels
do.
"""

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm


def _norm_shape(normalized_shape):
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


def fused_layer_norm_affine(input, weight, bias, normalized_shape, eps=1e-6):
    return layer_norm(input, normalized_shape, weight, bias, eps)


def fused_layer_norm(input, normalized_shape, eps=1e-6):
    return layer_norm(input, normalized_shape, None, None, eps)


def mixed_dtype_fused_layer_norm_affine(input, weight, bias,
                                        normalized_shape, eps=1e-6):
    return layer_norm(input, normalized_shape, weight, bias, eps,
                      out_dtype=weight.dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims with an fp32
    ``weight`` (ones) and ``bias`` (zeros), or neither without
    ``elementwise_affine``."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 device=None):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=torch.float32, device=device))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=torch.float32, device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x, out_dtype=None):
        """Normalize ``x`` in fp32; the result is rounded to x's dtype and
        then to ``out_dtype`` (default: x's dtype)."""
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.eps, out_dtype)

    def extra_repr(self):
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")


class MixedFusedLayerNorm(FusedLayerNorm):
    """LayerNorm whose output dtype is the parameters' (fp32). It always
    has its parameters: ``elementwise_affine`` is accepted and not read,
    as in JAX."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 device=None):
        super().__init__(normalized_shape, eps, True, device)

    def forward(self, x):
        return mixed_dtype_fused_layer_norm_affine(
            x, self.weight, self.bias, self.normalized_shape, self.eps)


class FusedRMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` dims with an fp32
    weight (initialised to ones)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 device=None):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
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
