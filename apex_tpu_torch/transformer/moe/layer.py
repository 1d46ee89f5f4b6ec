"""Switch/GShard MoE MLP at expert-parallel world size 1.

Counterpart of ``apex_tpu/transformer/moe/layer.py`` ``ExpertMLP`` and
``SwitchMLP``: tokens [s, b, h] -> router -> experts -> the gate-weighted
sum of each token's expert outputs, with the ``"ragged"`` dispatch (rows
sorted by expert, one grouped product per expert, no capacity: the
dropless default that ``"auto"`` picks) and the ``"scatter"`` dispatch
([E, C, h] slots with capacity drops). ``lax.ragged_dot`` is a grouped
GEMM that XLA computes outside any Pallas kernel; here it is a loop of
``torch.matmul`` over the experts' groups, whose sizes come to the host
once a call (one sync a MoE layer). The expert products take
``compute_dtype`` operands and accumulate in fp32, and the activation is
fp32, as in JAX.

Each token's k weighted expert outputs are summed in a fixed order
(ascending expert, the order in which JAX's scatter-add meets them), not
with atomics, so two runs route and combine identically wherever their
inputs agree. The router's aux loss, z-loss and dropped fraction, which
JAX sows into ``moe_losses``, are left on the module after each call as
:attr:`SwitchMLP.aux_loss`, ``z_loss`` and ``dropped_fraction``.

Not ported (ROADMAP queue A item 6): expert parallelism, the einsum
dispatch, sequence parallelism, expert-choice routing and jitter.
"""

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.transformer.moe.router import (
    _ITEM_6,
    TopKRouter,
    expert_capacity,
)
from apex_tpu_torch.transformer.parallel_state import refuse_tensor_parallel


def _grouped_matmul(x, w, sizes, compute_dtype):
    """x [N, K] (rows grouped by expert, ``sizes`` rows each) times w[e]
    [K, F] for each group e: ``compute_dtype`` operands, fp32 products
    and sums (``lax.ragged_dot`` with ``preferred_element_type=float32``)
    -> [N, F] fp32."""
    parts, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            parts.append(torch.matmul(x[start:start + n].float(),
                                      w[e].to(compute_dtype).float()))
        start += n
    if not parts:
        return x.new_zeros((0, w.shape[-1]), dtype=torch.float32)
    return torch.cat(parts)


class ExpertMLP(nn.Module):
    """Grouped FFN over experts, h -> ffn -> h per expert, in one of two
    layouts with the same parameters: slotted [E, S, h], or ragged [N, h]
    with ``group_sizes`` [E] (rows grouped by expert). ``"swiglu"``: w1
    [E, h, 2*ffn] a fused [gate | up] projection, no biases, returns fp32;
    ``"gelu"`` (tanh approximation, as ``jax.nn.gelu``): w1 [E, h, ffn]
    with biases b1 [E, ffn], b2 [E, h] (the ragged layout gathers each
    row's by ``expert_idx``)."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 num_local_experts: int, activation: str = "gelu",
                 params_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        if activation not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.swiglu = activation == "swiglu"
        self.compute_dtype = compute_dtype
        E, h, f = num_local_experts, hidden_size, ffn_hidden_size
        self.w1 = nn.Parameter(torch.empty(
            E, h, f * (2 if self.swiglu else 1), dtype=params_dtype,
            device=device))
        self.w2 = nn.Parameter(torch.empty(E, f, h, dtype=params_dtype,
                                           device=device))
        if not self.swiglu:
            self.b1 = nn.Parameter(torch.zeros(E, f, dtype=params_dtype,
                                               device=device))
            self.b2 = nn.Parameter(torch.zeros(E, h, dtype=params_dtype,
                                               device=device))

    def forward(self, x, group_sizes=None, expert_idx=None):
        cd = self.compute_dtype
        ragged = group_sizes is not None
        if not self.swiglu and ragged and expert_idx is None:
            raise ValueError("ragged gelu experts need expert_idx for "
                             "per-row bias gathers")
        x = x.to(cd)
        if ragged:
            sizes = group_sizes.tolist()  # the one host sync of the call
            h1 = _grouped_matmul(x, self.w1, sizes, cd)
        else:
            h1 = torch.bmm(x.float(), self.w1.to(cd).float())
        if self.swiglu:
            gate, up = h1.chunk(2, dim=-1)
            a = (F.silu(gate) * up).to(cd)
        else:
            bias1 = self.b1[expert_idx] if ragged else self.b1[:, None, :]
            a = F.gelu(h1 + bias1.float(), approximate="tanh").to(cd)
        if ragged:
            y = _grouped_matmul(a, self.w2, sizes, cd)
        else:
            y = torch.bmm(a.float(), self.w2.to(cd).float())
        if self.swiglu:
            return y
        bias2 = self.b2[expert_idx] if ragged else self.b2[:, None, :]
        return y + bias2.float()


def _combine(contrib, order, num_tokens, top_k):
    """out[t] = the sum of token t's k rows of ``contrib`` (in the sorted
    order), added one after another in the order the rows appear there:
    ascending expert."""
    n = order.shape[0]
    where = torch.empty_like(order)
    where[order] = torch.arange(n, device=order.device)
    rows = where.view(top_k, num_tokens).t().sort(dim=1).values  # [T, k]
    out = contrib[rows[:, 0]]
    for j in range(1, top_k):
        out = out + contrib[rows[:, j]]
    return out


class SwitchMLP(nn.Module):
    """Drop-in MoE replacement for an MLP: hidden_states [s, b, h] ->
    [s, b, h] in ``compute_dtype``. ``dispatch_mode`` ``"auto"`` takes
    ``"scatter"`` when the capacity can drop tokens (capacity <
    tokens), else ``"ragged"``, as JAX at ep 1."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25, jitter_eps: float = 0.0,
                 router_type: str = "top_k", normalize_topk: bool = True,
                 activation: str = "gelu", params_dtype=torch.float32,
                 compute_dtype=torch.bfloat16,
                 sequence_parallel_enabled: bool = False,
                 dispatch_mode: str = "auto", device=None):
        super().__init__()
        refuse_tensor_parallel("SwitchMLP (a mixture-of-experts layer)")
        if dispatch_mode == "einsum":
            raise NotImplementedError(
                f"dispatch_mode 'einsum' is not ported yet: {_ITEM_6}")
        if dispatch_mode not in ("auto", "scatter", "ragged"):
            raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
        if sequence_parallel_enabled:
            raise NotImplementedError(
                f"sequence parallelism is not ported yet: {_ITEM_6}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self.compute_dtype = compute_dtype
        self.router = TopKRouter(
            hidden_size, num_experts, top_k, capacity_factor, jitter_eps,
            normalize_topk, router_type, params_dtype, device=device)
        self.experts = ExpertMLP(hidden_size, ffn_hidden_size, num_experts,
                                 activation, params_dtype, compute_dtype,
                                 device)
        self.aux_loss = self.z_loss = self.dropped_fraction = None

    def _resolve_dispatch(self, capacity: int, num_tokens: int) -> str:
        if self.dispatch_mode == "auto":
            return "scatter" if capacity < num_tokens else "ragged"
        return self.dispatch_mode

    def forward(self, hidden_states):
        cd = self.compute_dtype
        shape = hidden_states.shape
        hidden = shape[-1]
        tokens = hidden_states.reshape(-1, hidden)
        T = tokens.shape[0]
        E, k = self.num_experts, self.top_k
        capacity = expert_capacity(T, E, k, self.capacity_factor)
        mode = self._resolve_dispatch(capacity, T)
        routing = self.router(tokens, routing_format={
            "scatter": "sorted", "ragged": "sorted_dropless"}[mode])
        self.aux_loss = routing.aux_loss
        self.z_loss = routing.z_loss
        self.dropped_fraction = routing.dropped_fraction
        x = tokens.to(cd)
        if mode == "ragged":
            y = self.experts(x[routing.token_idx], group_sizes=routing.counts,
                             expert_idx=routing.expert_idx)
            contrib = y.float() * routing.gate[:, None]
        else:
            EC = E * capacity
            # slot -> source token (empty slots read the zero row at T)
            kept = routing.slot < EC
            inv = torch.full((EC,), T, dtype=torch.long, device=x.device)
            inv[routing.slot[kept]] = routing.token_idx[kept]
            x_pad = torch.cat([x, x.new_zeros(1, hidden)])
            expert_out = self.experts(
                x_pad[inv].reshape(E, capacity, hidden)).to(cd)
            # dropped rows read a clamped slot and carry gate 0
            safe = routing.slot.clamp(max=EC - 1)
            contrib = (expert_out.reshape(EC, hidden)[safe].float()
                       * routing.gate[:, None])
        out = _combine(contrib, routing.order, T, k)
        return out.reshape(shape).to(cd)
