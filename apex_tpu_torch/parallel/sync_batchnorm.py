"""SyncBatchNorm: batch norm with statistics summed over a process group.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` (reference
apex/parallel/sync_batchnorm.py and optimized_sync_batchnorm*.py), with
JAX's semantics: channels last (the features are ``x.shape[-1]``),
count-weighted local sums and sums of squares all-reduced over the group
(the Welford merge across ranks, robust to per-rank batch sizes), then
``var = E[x^2] - mean^2`` in fp32; flax's names (parameters ``scale``
and ``bias``, buffers ``mean`` and ``var``) and momentum convention
(``m * old + (1 - m) * new``, m = 0.9), the unbiased running variance,
the fused ReLU and the additive ``z`` (BN-Add-ReLU). ``axis_name=None``
takes local statistics, and so does an axis while no process group is
initialized, as JAX does for an unbound axis. Gradients flow through the
summed statistics (the sum's backward sums the cotangents). No kernel:
the ResNet that uses it is ROADMAP item 8.
"""

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.parallel.groups import axis_group


def sync_batch_norm(x, mean, var, weight, bias, eps):
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


class _SumOverGroup(torch.autograd.Function):
    """All-reduce SUM whose backward all-reduces the cotangent (every
    rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _global_stats(x, group, reduce_axes):
    """Count-weighted mean and variance over ``reduce_axes`` and the
    group's ranks (``group=None``: this rank only), and the total count."""
    count = 1.0
    for a in reduce_axes:
        count *= x.shape[a]
    x32 = x.float()
    count = torch.full((1,), count, dtype=torch.float32, device=x.device)
    stats = torch.cat([count, torch.sum(x32, dim=reduce_axes),
                       torch.sum(torch.square(x32), dim=reduce_axes)])
    if group is not None:
        stats = _SumOverGroup.apply(stats, group)
    features = x.shape[-1]
    total_count = stats[0]
    mean = stats[1:1 + features] / total_count
    var = stats[1 + features:] / total_count - torch.square(mean)
    return mean, var, total_count


class SyncBatchNorm(nn.Module):
    """BatchNorm over channels-last input whose statistics are summed over
    the process group of ``axis_name`` (flax.linen.BatchNorm's interface
    plus ``fuse_relu`` and the additive ``z``)."""

    def __init__(self, num_features: int, *,
                 use_running_average: Optional[bool] = None,
                 axis_name: Optional[str] = "dp", momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=None,
                 param_dtype=torch.float32, use_bias: bool = True,
                 use_scale: bool = True, fuse_relu: bool = False,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.use_running_average = use_running_average
        self.axis_name = axis_name
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.fuse_relu = fuse_relu
        self.scale = (nn.Parameter(torch.ones(num_features, dtype=param_dtype,
                                              device=device))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        self.register_buffer("mean", torch.zeros(num_features,
                                                 dtype=torch.float32,
                                                 device=device))
        self.register_buffer("var", torch.ones(num_features,
                                               dtype=torch.float32,
                                               device=device))

    def _group(self):
        if self.axis_name is None or not dist.is_initialized():
            return None
        return axis_group(self.axis_name)

    def forward(self, x, use_running_average: Optional[bool] = None, z=None):
        """``use_running_average`` here or at construction (not both; with
        neither, ``not self.training``): True normalizes with the running
        statistics, False with the batch's, which also updates them."""
        if use_running_average is not None \
                and self.use_running_average is not None:
            raise ValueError("use_running_average was given both at "
                             "construction and in the call")
        if use_running_average is None:
            use_running_average = self.use_running_average
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            reduce_axes = tuple(range(x.dim() - 1))
            mean, var, total_count = _global_stats(x, self._group(),
                                                   reduce_axes)
            with torch.no_grad():
                unbiased = var * total_count / torch.clamp_min(
                    total_count - 1, 1)
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * unbiased)
        y = sync_batch_norm(x.float(), mean, var, self.scale, self.bias,
                            self.epsilon)
        if z is not None:
            y = y + z.float()
        if self.fuse_relu:
            y = torch.clamp_min(y, 0.0)
        return y.to(self.dtype or x.dtype)
