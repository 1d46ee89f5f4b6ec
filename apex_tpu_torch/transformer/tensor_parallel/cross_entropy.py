"""Vocab-parallel cross entropy.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
``vocab_parallel_cross_entropy``: each rank holds the logits of its
vocabulary shard [..., vocab / tp]. In fp32: the row max is taken over
the group (a MAX all-reduce of the local maxima, outside autograd) and
subtracted; the target's logit is looked up on the rank whose range
holds it (elsewhere 0) and summed over the group, as is the exp-sum;
the loss is ``log(sum(exp)) - target``, with optional label smoothing.
The sums are :func:`reduce_from_tensor_model_parallel_region`, whose
backward is the identity, so each rank back-propagates its own shard and
autograd gives the reference's softmax minus one-hot. A target outside
``[0, vocab)`` (an ignore label such as -100) lies in no rank's range: it
is gathered at index 0 and its predicted logit is 0, as JAX masks it. At
world size 1 no collective runs. There is no kernel here, as in the JAX
package.
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import groups
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    reduce_from_tensor_model_parallel_region as _allreduce,
)


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing=0.0,
                                 axis_name=TENSOR_PARALLEL_AXIS):
    """Per-token loss ``[...]`` of this rank's logits ``[..., vocab / tp]``
    against integer labels ``[...]`` in the global vocabulary."""
    world = groups.axis_size(axis_name)
    rank = groups.axis_rank(axis_name)
    logits = vocab_parallel_logits.float()
    global_max = torch.amax(logits.detach(), dim=-1)
    if world > 1:
        dist.all_reduce(global_max, op=dist.ReduceOp.MAX,
                        group=groups.axis_group(axis_name))
    logits = logits - global_max[..., None]

    partition = logits.shape[-1]
    start = rank * partition
    target = target.long()
    in_range = (target >= start) & (target < start + partition)
    masked = torch.where(in_range, target - start, torch.zeros_like(target))
    predicted = torch.gather(logits, -1, masked[..., None])[..., 0]
    predicted = torch.where(in_range, predicted, torch.zeros_like(predicted))
    exp_sum = torch.sum(torch.exp(logits), dim=-1)
    if world > 1:
        predicted = _allreduce(predicted, axis_name)
        exp_sum = _allreduce(exp_sum, axis_name)
    loss = torch.log(exp_sum) - predicted

    if label_smoothing > 0:
        vocab_size = partition * world
        smoothing = label_smoothing * vocab_size / (vocab_size - 1)
        log_probs_sum = torch.sum(logits - torch.log(exp_sum)[..., None],
                                  dim=-1)
        if world > 1:
            log_probs_sum = _allreduce(log_probs_sum, axis_name)
        loss = ((1.0 - smoothing) * loss
                - smoothing * (log_probs_sum / vocab_size))
    return loss
