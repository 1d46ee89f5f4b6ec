"""Broadcast a batch from the tp source rank (``apex_tpu/transformer/
tensor_parallel/data.py``; reference data.py ``broadcast_data``)."""

import torch.distributed as dist

from apex_tpu_torch.parallel import groups
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS


def broadcast_data(keys, data, datatype, axis_name=TENSOR_PARALLEL_AXIS):
    """``{key: data[key] as datatype}``, each sent from tp rank 0 of this
    rank's group to the others (a copy where the group has one rank)."""
    size = groups.axis_size(axis_name)
    out = {}
    for k in keys:
        v = data[k].to(datatype, copy=True)
        if size > 1:
            group = groups.axis_group(axis_name)
            dist.broadcast(v, src=dist.get_global_rank(group, 0), group=group)
        out[k] = v
    return out
