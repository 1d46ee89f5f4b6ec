"""Fused scale + mask + softmax, with its gradient.

Counterpart of ``apex_tpu/transformer/functional/fused_softmax.py`` and
the custom VJPs behind it (``apex_tpu/kernels/softmax.py``): each
forward launches its softmax kernel (scaled, scaled-masked or causal)
and saves its output, each backward launches the softmax backward
kernel, ``dx = scale * y * (dy - sum(dy * y))``, on the saved
probabilities and the incoming gradient rounded to their dtype; masked
keys have y = 0, so their dx is 0. CPU tensors take the kernels' plain
versions. The models call these functions directly;
:class:`FusedScaleMaskSoftmax` is the reference's module front end, for
callers that use it. Masks are non-zero (True) where masked out.
"""

import torch

from apex_tpu_torch.kernels import softmax as _kernels
from apex_tpu_torch.transformer.enums import AttnMaskType


def _softmax_bwd(ctx, dy):
    (y,) = ctx.saved_tensors
    return _kernels.softmax_bwd(y, dy.to(y.dtype).contiguous(), ctx.scale)


class _CausalSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        y = _kernels.causal_softmax_fwd(x, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        return _softmax_bwd(ctx, dy), None


class _ScaledSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale):
        y = _kernels.scaled_softmax_fwd(x, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        return _softmax_bwd(ctx, dy), None


class _ScaledMaskedSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, scale):
        y = _kernels.scaled_masked_softmax_fwd(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        return _softmax_bwd(ctx, dy), None, None


def scaled_upper_triang_masked_softmax(x, scale):
    """Causal softmax of ``x * scale`` over ``[b, sq, sk]`` (key ``j`` of
    row ``i`` is masked when ``j > i + sk - sq``), in x's dtype and
    differentiable in x. A 4-D ``[b, np, sq, sk]`` caller reshapes to
    ``[b * np, sq, sk]`` first, as the JAX model does."""
    if x.dim() != 3:
        raise ValueError(f"scaled_upper_triang_masked_softmax: x must be "
                         f"[b, sq, sk], got {tuple(x.shape)}")
    return _CausalSoftmax.apply(x, float(scale))


def scaled_masked_softmax(x, mask, scale):
    """Softmax of ``x * scale`` over the last dim with the keys where
    ``mask`` (broadcast to x's shape, e.g. ``[b, 1, sq, sk]``) is non-zero
    masked out; :func:`scaled_softmax` when ``mask`` is None. A row whose
    every key is masked is NaN, as in JAX."""
    if mask is None:
        return scaled_softmax(x, scale)
    try:
        shape = torch.broadcast_shapes(mask.shape, x.shape)
    except RuntimeError:
        shape = None
    if shape != x.shape:
        raise ValueError(f"scaled_masked_softmax: mask {tuple(mask.shape)} "
                         f"does not broadcast to x {tuple(x.shape)}")
    return _ScaledMaskedSoftmax.apply(x, mask, float(scale))


def scaled_softmax(x, scale):
    """Softmax of ``x * scale`` over the last dim, no mask."""
    return _ScaledSoftmax.apply(x, float(scale))


class FusedScaleMaskSoftmax:
    """Dispatching softmax front end with the reference's arguments
    (input_in_fp16/bf16, attn_mask_type, scaled_masked_softmax_fusion,
    mask_func, softmax_in_fp32, scale): the fused kernels where
    :meth:`is_kernel_available` says so, else JAX's unfused branch, a
    softmax in plain PyTorch that launches no kernel (fp32 input always
    takes it, as in JAX). No model of the package calls this class, so
    it lies off every path ``chip_smoke.py`` drives."""

    def __init__(self, input_in_fp16, input_in_bf16, attn_mask_type,
                 scaled_masked_softmax_fusion, mask_func, softmax_in_fp32,
                 scale):
        if input_in_fp16 and input_in_bf16:
            raise ValueError("both fp16 and bf16 flags cannot be active at "
                             "the same time.")
        if scale is not None and not softmax_in_fp32:
            raise ValueError("softmax should be in fp32 when scaled")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale

    def __call__(self, input, mask):
        if input.dim() != 4:
            raise ValueError(f"FusedScaleMaskSoftmax: input must be [b, np, "
                             f"sq, sk], got {tuple(input.shape)}")
        if self.is_kernel_available(mask, *input.shape):
            return self.forward_fused_softmax(input, mask)
        return self.forward_torch_softmax(input, mask)

    def is_kernel_available(self, mask, b, np_, sq, sk):
        """The reference's availability heuristic (JAX keeps it for
        dispatch parity), with its power-of-two rows per CUDA block."""
        attn_batches = b * np_
        if (self.scaled_masked_softmax_fusion
                and self.input_in_float16
                and 16 < sk <= 16384
                and sq % 4 == 0
                and sk % 4 == 0
                and attn_batches % 4 == 0):
            pow2 = 1 << (sk - 1).bit_length()
            batch_per_block = 4 * 32 // min(pow2, 32) * (2 if pow2 <= 128
                                                         else 1)
            if self.attn_mask_type == AttnMaskType.causal:
                return attn_batches % batch_per_block == 0
            return sq % batch_per_block == 0
        return False

    def forward_fused_softmax(self, input, mask):
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type == AttnMaskType.causal:
            b, np_, sq, sk = input.shape
            if sq != sk:
                raise ValueError("causal mask is only for self attention")
            out = scaled_upper_triang_masked_softmax(
                input.reshape(-1, sq, sk), scale)
            return out.reshape(b, np_, sq, sk)
        return scaled_masked_softmax(input, mask, scale)

    def forward_torch_softmax(self, input, mask):
        """The unfused form: optional fp32 upcast, scale, ``mask_func``,
        softmax, cast back."""
        orig_dtype = input.dtype
        if self.input_in_float16 and self.softmax_in_fp32:
            input = input.float()
        if self.scale is not None:
            input = input * self.scale
        mask_output = (self.mask_func(input, mask) if mask is not None
                       else input)
        probs = torch.exp(mask_output - torch.amax(mask_output, dim=-1,
                                                   keepdim=True))
        probs = probs / torch.sum(probs, dim=-1, keepdim=True)
        if self.input_in_float16 and self.softmax_in_fp32:
            probs = probs.to(orig_dtype)
        return probs


class GenericFusedScaleMaskSoftmax(FusedScaleMaskSoftmax):
    """The shape-generic variant: padding mask type, always fused."""

    def __init__(self, input_in_fp16, input_in_bf16, mask_func,
                 softmax_in_fp32, scale):
        super().__init__(input_in_fp16, input_in_bf16, AttnMaskType.padding,
                         True, mask_func, softmax_in_fp32, scale)

    def is_kernel_available(self, mask, b, np_, sq, sk):
        return True
