"""The tensor-parallel region ops: a collective forward paired with its
transpose backward.

Counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``
(reference apex/transformer/tensor_parallel/mappings.py): each op is a
``torch.autograd.Function`` over the process group of ``axis_name``
(:mod:`apex_tpu_torch.parallel.groups`; ``"tp"`` by default, bound by
:func:`~apex_tpu_torch.transformer.parallel_state.initialize_model_parallel`).
Where the axis has one rank, or names no group, each op is the identity,
as the JAX ops return early when their axis size is 1.

- ``copy_to``: identity forward, all-reduce backward;
- ``reduce_from``: all-reduce forward, identity backward;
- ``scatter_to`` / ``gather_from``: split / gather the last dim, and the
  other way round backward;
- sequence parallel, along the first dim: ``scatter_to_sequence``
  (split; gather), ``reduce_scatter_to_sequence`` (reduce-scatter;
  gather), ``gather_from_sequence`` (gather; reduce-scatter, or split
  with ``tensor_parallel_output_grad=False``).
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import groups
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS


def _reduce(x, group):
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def _split(x, dim, group):
    size = dist.get_world_size(group)
    shard = x.shape[dim] // size
    return x.narrow(dim, dist.get_rank(group) * shard, shard).contiguous()


def _gather(x, dim, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x, dim, group):
    size = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


_OPS = {"reduce": lambda x, g: _reduce(x, g),
        "identity": lambda x, g: x.view_as(x),
        "split_last": lambda x, g: _split(x, -1, g),
        "gather_last": lambda x, g: _gather(x, -1, g),
        "split_first": lambda x, g: _split(x, 0, g),
        "gather_first": lambda x, g: _gather(x, 0, g),
        "reduce_scatter_first": lambda x, g: _reduce_scatter(x, 0, g)}


class _Region(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, fwd, bwd):
        ctx.group, ctx.bwd = group, bwd
        return _OPS[fwd](x, group)

    @staticmethod
    def backward(ctx, g):
        return _OPS[ctx.bwd](g, ctx.group), None, None, None


def _region(fwd, bwd):
    def op(x, axis_name=TENSOR_PARALLEL_AXIS):
        if groups.axis_size(axis_name) == 1:
            return x
        return _Region.apply(x, groups.axis_group(axis_name), fwd, bwd)
    return op


copy_to_tensor_model_parallel_region = _region("identity", "reduce")
reduce_from_tensor_model_parallel_region = _region("reduce", "identity")
scatter_to_tensor_model_parallel_region = _region("split_last", "gather_last")
gather_from_tensor_model_parallel_region = _region("gather_last", "split_last")
scatter_to_sequence_parallel_region = _region("split_first", "gather_first")
reduce_scatter_to_sequence_parallel_region = _region("reduce_scatter_first",
                                                     "gather_first")


def gather_from_sequence_parallel_region(x, tensor_parallel_output_grad=True,
                                         axis_name=TENSOR_PARALLEL_AXIS):
    """All-gather along the first dim; backward reduce-scatters (the
    gathered activation fed a tensor-parallel region) or, with
    ``tensor_parallel_output_grad=False``, splits."""
    if groups.axis_size(axis_name) == 1:
        return x
    bwd = ("reduce_scatter_first" if tensor_parallel_output_grad
           else "split_first")
    return _Region.apply(x, groups.axis_group(axis_name), "gather_first",
                         bwd)
