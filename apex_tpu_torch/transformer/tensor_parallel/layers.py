"""Megatron-style tensor-parallel linear and embedding layers.

Counterparts of ``apex_tpu/transformer/tensor_parallel/layers.py``, with
its weight layouts ([in, out] for the linears, [vocab, hidden] for the
embedding) so that parameters carry across one to one. Each layer holds
this rank's shard, sized from
:func:`~apex_tpu_torch.transformer.parallel_state.get_tensor_model_parallel_world_size`
when it is built, as the JAX layers size theirs; its collectives run over
the process group of ``axis_name`` (``"tp"``) through the region ops of
:mod:`.mappings`, each the identity at world size 1. The products are
plain ``torch.matmul``, as the JAX package leaves them to XLA.

Numerics follow the JAX layers: the weights stay in ``params_dtype``
(fp32) and the input is promoted to it, so the product runs in fp32 and
is rounded back to the input's dtype; a bias is added after that
rounding (a row-parallel bias after the reduction), which promotes the
output to fp32 as ``bf16 + fp32`` does in JAX.
"""

import torch
from torch import nn

from apex_tpu_torch.parallel import groups
from apex_tpu_torch.transformer.parallel_state import (
    TENSOR_PARALLEL_AXIS,
    get_tensor_model_parallel_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide


def _linear(x, weight, bias):
    out = torch.matmul(x.to(weight.dtype), weight).to(x.dtype)
    return out if bias is None else out + bias


def linear_with_grad_accumulation_and_async_allreduce(
        input, weight, bias=None, sequence_parallel_enabled=False,
        axis_name=TENSOR_PARALLEL_AXIS):
    """The column-parallel product (reference layers.py:279-438): with
    ``sequence_parallel_enabled`` the sequence-sharded input is gathered
    (and its gradient reduce-scattered); else the input's gradient is
    all-reduced. Gradients accumulate as autograd accumulates them."""
    if sequence_parallel_enabled:
        total = gather_from_sequence_parallel_region(input, True, axis_name)
    else:
        total = copy_to_tensor_model_parallel_region(input, axis_name)
    return _linear(total, weight, bias)


class ColumnParallelLinear(nn.Module):
    """Y = XA + b with A = [A_1 .. A_p] split along its output dim: this
    rank holds A_i [input_size, output_size / tp]. ``gather_output``
    gathers Y's shards; ``skip_bias_add`` returns (Y, b) unadded;
    ``sequence_parallel_enabled`` takes a sequence-sharded X. The weight
    is left for the caller to fill (``models.init_weights`` or a
    ``state_dict``)."""

    def __init__(self, input_size, output_size, bias=True, gather_output=True,
                 skip_bias_add=False, params_dtype=torch.float32,
                 sequence_parallel_enabled=False,
                 axis_name=TENSOR_PARALLEL_AXIS, device=None):
        super().__init__()
        if gather_output and sequence_parallel_enabled:
            raise ValueError("ColumnParallelLinear: gather_output and "
                             "sequence_parallel_enabled exclude each other")
        local = divide(output_size, get_tensor_model_parallel_world_size())
        self.gather_output = gather_output
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.empty(
            input_size, local, dtype=params_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(local, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x):
        out = linear_with_grad_accumulation_and_async_allreduce(
            x, self.weight, None if self.skip_bias_add else self.bias,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            axis_name=self.axis_name)
        if self.gather_output:
            out = gather_from_tensor_model_parallel_region(out,
                                                           self.axis_name)
        if self.skip_bias_add:
            return out, self.bias
        return out


class RowParallelLinear(nn.Module):
    """Y = XA + b with A = [A_1; ..; A_p] split along its input dim: this
    rank holds A_i [input_size / tp, output_size]. X is split along its
    last dim first unless ``input_is_parallel``; the partial products are
    all-reduced (reduce-scattered along the sequence with
    ``sequence_parallel_enabled``) and the bias is added after."""

    def __init__(self, input_size, output_size, bias=True,
                 input_is_parallel=False, skip_bias_add=False,
                 params_dtype=torch.float32, sequence_parallel_enabled=False,
                 axis_name=TENSOR_PARALLEL_AXIS, device=None):
        super().__init__()
        if sequence_parallel_enabled and not input_is_parallel:
            raise ValueError("RowParallelLinear: sequence_parallel_enabled "
                             "needs input_is_parallel")
        local = divide(input_size, get_tensor_model_parallel_world_size())
        self.input_is_parallel = input_is_parallel
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.empty(
            local, output_size, dtype=params_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(output_size, dtype=params_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x, self.axis_name)
        out = _linear(x, self.weight, None)
        if self.sequence_parallel_enabled:
            out = reduce_scatter_to_sequence_parallel_region(out,
                                                             self.axis_name)
        else:
            out = reduce_from_tensor_model_parallel_region(out, self.axis_name)
        if self.skip_bias_add:
            return out, self.bias
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(nn.Module):
    """Token embedding split along the vocabulary: this rank holds rows
    [rank * V/tp, (rank + 1) * V/tp) of the [V, hidden] table.
    :meth:`attend` is the tied LM head (this rank's vocabulary columns of
    the logits)."""

    def __init__(self, num_embeddings, embedding_dim,
                 params_dtype=torch.float32, device=None,
                 axis_name=TENSOR_PARALLEL_AXIS):
        super().__init__()
        self.axis_name = axis_name
        local = divide(num_embeddings, get_tensor_model_parallel_world_size())
        self.weight = nn.Parameter(torch.empty(
            local, embedding_dim, dtype=params_dtype, device=device))

    def forward(self, tokens):
        """Rows of the table. At world size 1 indexed as JAX indexes: a
        negative token id counts from the end, and an id still outside
        ``[0, num_embeddings)`` is clamped into it, as JAX's gather clamps.
        At world size > 1, as JAX's sharded lookup: each rank looks up the
        ids in its range (others give zero rows), then the rows are summed
        over the group."""
        n = self.weight.shape[0]
        if groups.axis_size(self.axis_name) == 1:
            tokens = torch.where(tokens < 0, tokens + n, tokens)
            return self.weight[tokens.clamp(0, n - 1)]
        start = groups.axis_rank(self.axis_name) * n
        in_range = (tokens >= start) & (tokens < start + n)
        local = torch.where(in_range, tokens - start, torch.zeros_like(tokens))
        out = torch.where(in_range[..., None], self.weight[local], 0.0)
        return reduce_from_tensor_model_parallel_region(out, self.axis_name)

    def attend(self, h):
        """[..., hidden] @ table.T -> logits [..., vocab / tp] in fp32, from
        the table rounded to h's dtype (fp32 accumulation)."""
        table = self.weight.to(h.dtype).float()
        return torch.matmul(h.float(), table.t())


def allreduce_sequence_parallel_grads(grads, is_sequence_parallel_param,
                                      axis_name=TENSOR_PARALLEL_AXIS):
    """Sum over the tp group the gradients of the parameters that saw only
    this rank's sequence shard (layer norms, position embeddings, the
    row-parallel biases under sequence parallelism).
    ``is_sequence_parallel_param(name)`` gets the "/"-joined key path of
    each leaf of the (nested) dict ``grads``. Returns a new dict."""
    size = groups.axis_size(axis_name)

    def fix(tree, prefix):
        out = {}
        for key, value in tree.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                out[key] = fix(value, name + "/")
            elif size > 1 and is_sequence_parallel_param(name):
                out[key] = reduce_from_tensor_model_parallel_region(
                    value, axis_name)
            else:
                out[key] = value
        return out

    return fix(grads, "")
