"""Tensor-parallel helpers (``apex_tpu/transformer/tensor_parallel/
utils.py``): ``divide``, ``split_tensor_along_last_dim``,
``VocabUtility``."""

import torch


def ensure_divisibility(numerator, denominator):
    assert numerator % denominator == 0, "{} is not divisible by {}".format(
        numerator, denominator)


def divide(numerator, denominator):
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions,
                                contiguous_split_chunks=False):
    """``num_partitions`` equal views of ``tensor`` along its last dim
    (copies, each contiguous, with ``contiguous_split_chunks``)."""
    size = divide(tensor.shape[-1], num_partitions)
    chunks = torch.split(tensor, size, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


class VocabUtility:
    """The [first, last) vocabulary range of a rank's shard."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(per_partition_vocab_size,
                                                  rank, world_size):
        index_f = rank * per_partition_vocab_size
        return index_f, index_f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size, rank,
                                           world_size):
        per_partition_vocab_size = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size, rank, world_size)
