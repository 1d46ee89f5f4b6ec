"""Fused RMSNorm entry point (forward only).

Counterpart of ``apex_tpu/ops/layer_norm.py`` ``rms_norm``. The kernel
lives in :mod:`apex_tpu_torch.kernels.norm`; this module keeps the shape
handling. The serving path needs no gradient, so there is no autograd
here yet: the backward kernel comes with training, as does LayerNorm.
"""

import math

from apex_tpu_torch.kernels import norm as _kernels


def rms_norm(x, normalized_shape, weight=None, eps=1e-5, out_dtype=None):
    """RMSNorm over the trailing ``normalized_shape`` dims, statistics in
    fp32, output in ``out_dtype`` (default: x's dtype)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    h = math.prod(normalized_shape)
    x2d = x.reshape(-1, h)
    w = weight.reshape(h) if weight is not None else None
    y = _kernels.rms_fwd(x2d, w, float(eps), out_dtype or x.dtype)
    return y.reshape(x.shape)
