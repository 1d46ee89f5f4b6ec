"""Fused scale + causal mask + softmax, with its gradient.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py``
``scaled_upper_triang_masked_softmax`` and the custom VJP behind it
(``apex_tpu/kernels/softmax.py``): the forward launches the causal
softmax kernel and saves its output, the backward launches the softmax
backward kernel, ``dx = scale * y * (dy - sum(dy * y))``, on the saved
probabilities and the incoming gradient rounded to their dtype. CPU
tensors take the kernels' plain versions. ``scaled_masked_softmax`` and
``scaled_softmax`` come with the BERT slice.
"""

import torch

from apex_tpu_torch.kernels import softmax as _kernels


class _CausalSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        y = _kernels.causal_softmax_fwd(x, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        dx = _kernels.softmax_bwd(y, dy.to(y.dtype).contiguous(), ctx.scale)
        return dx, None


def scaled_upper_triang_masked_softmax(x, scale):
    """Causal softmax of ``x * scale`` over ``[b, sq, sk]`` (key ``j`` of
    row ``i`` is masked when ``j > i + sk - sq``), in x's dtype and
    differentiable in x. A 4-D ``[b, np, sq, sk]`` caller reshapes to
    ``[b * np, sq, sk]`` first, as the JAX model does."""
    if x.dim() != 3:
        raise ValueError(f"scaled_upper_triang_masked_softmax: x must be "
                         f"[b, sq, sk], got {tuple(x.shape)}")
    return _CausalSoftmax.apply(x, float(scale))
