"""Vocab-parallel cross entropy at world size 1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
``vocab_parallel_cross_entropy`` on one rank (the whole vocabulary
local): fp32 logits shifted by their detached row max, the target's
logit picked out, ``log(sum(exp)) - target``, with optional label
smoothing. A target outside ``[0, vocab)`` (an ignore label such as
-100) is gathered at index 0 and its predicted logit taken as 0, as JAX
masks a target that lies outside the rank's vocabulary shard. Autograd
gives the reference's hand-written backward, softmax minus one-hot.
There is no kernel here, as in the JAX package.
"""

import torch


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing=0.0):
    """Per-token loss ``[...]`` of logits ``[..., vocab]`` against integer
    labels ``[...]``."""
    logits = vocab_parallel_logits.float()
    logits = logits - torch.amax(logits.detach(), dim=-1, keepdim=True)
    target = target.long()
    in_range = (target >= 0) & (target < logits.shape[-1])
    masked = torch.where(in_range, target, torch.zeros_like(target))
    predicted = torch.gather(logits, -1, masked[..., None])[..., 0]
    predicted = torch.where(in_range, predicted, torch.zeros_like(predicted))
    exp_sum = torch.sum(torch.exp(logits), dim=-1)
    loss = torch.log(exp_sum) - predicted
    if label_smoothing > 0:
        vocab_size = logits.shape[-1]
        smoothing = label_smoothing * vocab_size / (vocab_size - 1)
        log_probs_sum = torch.sum(logits - torch.log(exp_sum)[..., None],
                                  dim=-1)
        loss = ((1.0 - smoothing) * loss
                - smoothing * (log_probs_sum / vocab_size))
    return loss
