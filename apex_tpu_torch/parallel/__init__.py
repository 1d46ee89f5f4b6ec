"""apex_tpu_torch.parallel: the data-parallel runtime on
``torch.distributed``.

Counterpart of ``apex_tpu/parallel``: :mod:`.compression` (the int8 block
core and the bf16/int8/int4 compressed collectives with error feedback),
:mod:`.distributed` (``DistributedDataParallel``, bucketed or per-leaf
gradient sync, ``Reducer``), :mod:`.sync_batchnorm`, :mod:`.LARC`,
:mod:`.multiproc` (process-group bring-up and the launcher),
:mod:`.groups` (mesh axis names -> process groups) and :mod:`.mesh2d`
(the 2-D (data, model) mesh step; import it by name) and
:mod:`.overlap` (``OverlappedDataParallel``, the backward with each
bucket's collective issued as its segment finishes, and
``overlapped_zero_step``, its ZeRO form). ``pipeline`` comes with
ROADMAP item 6.
"""

import copy

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import compression  # noqa: F401
from apex_tpu_torch.parallel import multiproc  # noqa: F401
from apex_tpu_torch.parallel import overlap  # noqa: F401
from apex_tpu_torch.parallel.compression import init_residual  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    all_reduce_gradients,
    all_reduce_gradients_bucketed,
    broadcast_params,
    flatten,
    plan_buckets,
    unflatten,
)
from apex_tpu_torch.parallel.groups import register_axis  # noqa: F401
from apex_tpu_torch.parallel.LARC import LARC  # noqa: F401
from apex_tpu_torch.parallel.overlap import (  # noqa: F401
    OverlappedDataParallel,
    overlapped_zero_step,
    plan_overlap,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    sync_batch_norm,
)


def convert_syncbn_model(module, process_group=None, channel_last=False):
    """Swap batch norm for :class:`SyncBatchNorm` (reference
    apex/parallel/__init__.py:21-97).

    A module with a ``norm_cls`` or ``bn_axis_name`` attribute gets a
    copy with ``norm_cls = SyncBatchNorm`` or ``bn_axis_name =
    process_group or "dp"``, as JAX replaces the field of a flax module.
    Otherwise every ``torch.nn`` BatchNorm inside ``module`` is replaced in
    place by a ``SyncBatchNorm`` with its statistics, affine parameters,
    eps and momentum (torch's 0.1 is flax's 0.9). The port's
    ``SyncBatchNorm`` is channels last, so that swap needs
    ``channel_last=True``: the caller's promise that the model feeds it
    [..., C] activations."""
    if hasattr(module, "norm_cls"):
        out = copy.copy(module)
        out.norm_cls = SyncBatchNorm
        return out
    if hasattr(module, "bn_axis_name"):
        out = copy.copy(module)
        out.bn_axis_name = process_group or "dp"
        return out
    bn = torch.nn.modules.batchnorm._BatchNorm
    if isinstance(module, bn):
        if not channel_last:
            raise ValueError(
                "convert_syncbn_model: SyncBatchNorm normalizes the last "
                "dimension (channels last); pass channel_last=True for a "
                "model that feeds its BatchNorm [..., C] activations")
        return _sync_bn_like(module, process_group)
    found = False
    for name, child in module.named_children():
        if isinstance(child, bn) or any(isinstance(m, bn)
                                        for m in child.modules()):
            setattr(module, name, convert_syncbn_model(
                child, process_group, channel_last))
            found = True
    if not found:
        raise TypeError(
            "convert_syncbn_model: pass a module holding torch BatchNorm "
            "layers or exposing `norm_cls` / `bn_axis_name`, or build with "
            "apex_tpu_torch.parallel.SyncBatchNorm directly")
    return module


def _sync_bn_like(bn, process_group):
    state = next(iter(bn.state_dict().values()), None)
    out = SyncBatchNorm(
        bn.num_features, axis_name=process_group or "dp",
        momentum=1.0 - (bn.momentum if bn.momentum is not None else 0.1),
        epsilon=bn.eps, use_bias=bn.affine, use_scale=bn.affine,
        device=None if state is None else state.device)
    with torch.no_grad():
        if bn.affine:
            out.scale.copy_(bn.weight)
            out.bias.copy_(bn.bias)
        if bn.track_running_stats:
            out.mean.copy_(bn.running_mean)
            out.var.copy_(bn.running_var)
    return out


def create_syncbn_process_group(group_size):
    """Split the default group into consecutive groups of ``group_size``
    ranks and return this rank's (``0``: ``None``, the whole group), to
    pass as a ``SyncBatchNorm`` ``axis_name``. Every rank must call it."""
    if group_size == 0:
        return None
    world = dist.get_world_size()
    if world % group_size:
        raise ValueError(f"create_syncbn_process_group: world size {world} "
                         f"is not a multiple of {group_size}")
    mine = None
    for start in range(0, world, group_size):
        group = dist.new_group(list(range(start, start + group_size)))
        if start <= dist.get_rank() < start + group_size:
            mine = group
    return mine
