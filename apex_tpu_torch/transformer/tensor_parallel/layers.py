"""Tensor-parallel linear and embedding layers at world size 1.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py``, with
its weight layouts ([in, out] for the linears, [vocab, hidden] for the
embedding) so that parameters carry across one to one. The products are
plain ``torch.matmul``, as the JAX package leaves them to XLA. Sharding
over a tensor-parallel group comes in a later slice.

Numerics follow the JAX layers: the weights stay in ``params_dtype``
(fp32) and the input is promoted to it, so the product runs in fp32 and
is rounded back to the input's dtype; a bias is added after that
rounding, which promotes the output to fp32 as ``bf16 + fp32`` does in
JAX.
"""

import torch
from torch import nn


def _linear(x, weight, bias):
    out = torch.matmul(x.to(weight.dtype), weight).to(x.dtype)
    return out if bias is None else out + bias


class ColumnParallelLinear(nn.Module):
    """Y = XA + b with A of shape [input_size, output_size]."""

    def __init__(self, input_size, output_size, bias=True,
                 params_dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            input_size, output_size, dtype=params_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(output_size, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x):
        return _linear(x, self.weight, self.bias)


class RowParallelLinear(ColumnParallelLinear):
    """Y = XA + b with A of shape [input_size, output_size]; at world size
    1 the same product as :class:`ColumnParallelLinear`."""


class VocabParallelEmbedding(nn.Module):
    """Token embedding with a [num_embeddings, embedding_dim] table;
    :meth:`attend` is the tied LM head."""

    def __init__(self, num_embeddings, embedding_dim,
                 params_dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, dtype=params_dtype, device=device))

    def forward(self, tokens):
        return self.weight[tokens]

    def attend(self, h):
        """[..., hidden] @ table.T -> logits [..., vocab] in fp32, from the
        table rounded to h's dtype (fp32 accumulation)."""
        table = self.weight.to(h.dtype).float()
        return torch.matmul(h.float(), table.t())
