"""Fused LayerNorm and RMSNorm entry points with their gradients.

Counterpart of ``apex_tpu/ops/layer_norm.py`` ``layer_norm`` and
``rms_norm`` and their custom VJPs. The kernels live in
:mod:`apex_tpu_torch.kernels.norm`; this module keeps the shape handling
and the autograd: each forward launches its norm kernel and saves its
input and weight, each backward launches the backward-dx kernel (which
recomputes the row statistics) on the output gradient rounded to the
input's dtype, and computes the weight's (and LayerNorm's bias's)
gradient in plain PyTorch, as the JAX VJP computes them outside its
kernel.
"""

import math

import torch

from apex_tpu_torch.kernels import norm as _kernels


def _flat_size(normalized_shape):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return math.prod(normalized_shape)


class _LayerNorm(torch.autograd.Function):
    """y = ln_fwd(x2d, w, b) rounded to x2d's dtype, then to
    ``out_dtype``."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, out_dtype):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _kernels.ln_fwd(x2d, weight, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x2d, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the JAX VJP rounds dy to x's dtype before the kernel
            dx = _kernels.ln_bwd_dx(dy.to(x2d.dtype).contiguous(), x2d,
                                    weight, ctx.eps)
        if weight is not None and ctx.needs_input_grad[1]:
            x = x2d.float()
            mean, var = _kernels._ln_stats(x)
            xhat = (x - mean) * torch.rsqrt(var + ctx.eps)
            dw = torch.sum(dy.float() * xhat, dim=0).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = torch.sum(dy.float(), dim=0).to(ctx.bias_dtype)
        return dx, dw, db, None, None


def layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5,
               out_dtype=None):
    """LayerNorm over the trailing ``normalized_shape`` dims, statistics
    in fp32, output in ``out_dtype`` (default: x's dtype); differentiable
    in x, weight and bias."""
    h = _flat_size(normalized_shape)
    x2d = x.reshape(-1, h)
    w = weight.reshape(h) if weight is not None else None
    b = bias.reshape(h) if bias is not None else None
    y = _LayerNorm.apply(x2d, w, b, float(eps), out_dtype or x.dtype)
    return y.reshape(x.shape)


class _RMSNorm(torch.autograd.Function):
    """y = rms_fwd(x2d, w) rounded to x2d's dtype, then to ``out_dtype``."""

    @staticmethod
    def forward(ctx, x2d, weight, eps, out_dtype):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        return _kernels.rms_fwd(x2d, weight, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x2d, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the JAX VJP rounds dy to x's dtype before the kernel
            dx = _kernels.rms_bwd_dx(dy.to(x2d.dtype).contiguous(), x2d,
                                     weight, ctx.eps)
        if weight is not None and ctx.needs_input_grad[1]:
            x = x2d.float()
            ms = torch.mean(x * x, dim=-1, keepdim=True)
            xhat = x * torch.rsqrt(ms + ctx.eps)
            dw = torch.sum(dy.float() * xhat, dim=0).to(weight.dtype)
        return dx, dw, None, None


def rms_norm(x, normalized_shape, weight=None, eps=1e-5, out_dtype=None):
    """RMSNorm over the trailing ``normalized_shape`` dims, statistics in
    fp32, output in ``out_dtype`` (default: x's dtype); differentiable in
    x and weight."""
    h = _flat_size(normalized_shape)
    x2d = x.reshape(-1, h)
    w = weight.reshape(h) if weight is not None else None
    y = _RMSNorm.apply(x2d, w, float(eps), out_dtype or x.dtype)
    return y.reshape(x.shape)
