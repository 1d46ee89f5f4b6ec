"""Top-k expert routing in the sorted formulation, at expert-parallel
world size 1.

Counterpart of ``apex_tpu/transformer/moe/router.py``:
:func:`expert_capacity`, the router losses, :func:`compute_routing_sorted`
(dropless, or with a per-expert capacity) and :class:`TopKRouter` with
``router_type="top_k"`` and the ``"sorted"`` and ``"sorted_dropless"``
formats. The logits are fp32 (``x @ gate`` in fp32; TF32 off), the gates
the raw softmax mass unless ``normalize_topk``. The top-k breaks ties
toward the lower expert index (as ``lax.top_k``) and the assignments are
sorted by expert with a stable sort (as ``jnp.argsort(stable=True)``),
so routing does not depend on the device's sort. There is no kernel
here, as in the JAX package.

Not ported (ROADMAP queue A item 6): expert-choice routing, the dense
``[T, E, C]`` one-hot format and router jitter; each raises.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

_ITEM_6 = "ROADMAP queue A item 6 (expert parallelism and the rest of MoE)"


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert slot count: a multiple of 8, capped near num_tokens
    (the JAX package's arithmetic, float rounding included)."""
    raw = max(1, int(num_tokens * top_k * capacity_factor / num_experts))
    rounded = -(-raw // 8) * 8
    cap = -(-max(1, num_tokens) // 8) * 8
    return min(rounded, cap)


def _router_losses(logits, probs, expert_fractions):
    """Switch aux loss E * sum_e f_e * mean_t p_te (``expert_fractions``
    the pre-drop share of assignments per expert) and the ST-MoE z-loss
    mean(logsumexp(logits)^2)."""
    E = logits.shape[-1]
    aux_loss = E * torch.sum(expert_fractions * probs.mean(dim=0))
    z = torch.logsumexp(logits, dim=-1)
    return aux_loss, torch.mean(z * z)


@dataclasses.dataclass
class SortedRouting:
    """Token -> expert assignments of T tokens, E experts, k choices: N =
    k*T rows ordered by expert (stable: choice rank major, then token).
    ``order`` is the permutation from the rank-major flat assignments
    (row ``r*T + t`` is token t's r-th choice) to this order."""

    token_idx: torch.Tensor   # [N] int64 - source token of each row
    expert_idx: torch.Tensor  # [N] int64 - expert of each row (ascending)
    gate: torch.Tensor        # [N] fp32 - combine weight (0 when dropped)
    counts: torch.Tensor      # [E] int64 - pre-drop rows per expert
    slot: Optional[torch.Tensor]  # [N] int64 in [0, E*C]; E*C = dropped
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    probs: torch.Tensor       # [T, E] router probabilities
    dropped_fraction: torch.Tensor
    order: torch.Tensor       # [N] int64


def _top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, ties
    broken toward the lower index, as ``lax.top_k`` does."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def compute_routing_sorted(logits, top_k: int, capacity: Optional[int],
                           normalize_topk: bool = True) -> SortedRouting:
    """Sort-based routing from router ``logits`` [T, E] (taken in fp32).
    ``capacity=None`` keeps every assignment; with a capacity, rows past
    C of an expert get gate 0 and the slot sentinel E*C (the first C rows
    of an expert in (rank, token) order win, JAX's drop rule)."""
    logits = logits.float()
    T, E = logits.shape
    N = top_k * T
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, top_k)
    gates = topv
    if normalize_topk and top_k > 1:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.t().reshape(N)
    flat_t = torch.arange(T, device=logits.device).repeat(top_k)
    flat_g = gates.t().reshape(N)
    order = torch.argsort(flat_e, stable=True)
    expert_sorted = flat_e[order]
    token_sorted = flat_t[order]
    gate_sorted = flat_g[order]

    counts = torch.bincount(flat_e, minlength=E)  # pre-drop
    group_start = torch.cumsum(counts, 0) - counts
    pos_in_expert = (torch.arange(N, device=logits.device)
                     - group_start[expert_sorted])
    if capacity is None:
        slot = None
        dropped = torch.zeros((), device=logits.device)
    else:
        kept = pos_in_expert < capacity
        slot = torch.where(kept, expert_sorted * capacity + pos_in_expert,
                           torch.full_like(expert_sorted, E * capacity))
        gate_sorted = torch.where(kept, gate_sorted,
                                  torch.zeros_like(gate_sorted))
        dropped = 1.0 - kept.sum().float() / N
    f = counts.float() / N
    aux_loss, z_loss = _router_losses(logits, probs, f)
    return SortedRouting(token_sorted, expert_sorted, gate_sorted, counts,
                         slot, aux_loss, z_loss, probs, dropped.detach(),
                         order)


class TopKRouter(nn.Module):
    """Learned gate ``gate_weight`` [h, E] (``params_dtype``): tokens [T, h]
    -> fp32 logits ``x @ gate`` -> :class:`SortedRouting` with capacity
    from :func:`expert_capacity` (``"sorted"``) or none
    (``"sorted_dropless"``). JAX's default format, ``"dense"``, is not
    ported, so the port defaults to ``"sorted"``."""

    def __init__(self, hidden_size: int, num_experts: int, top_k: int = 1,
                 capacity_factor: float = 1.25, jitter_eps: float = 0.0,
                 normalize_topk: bool = True, router_type: str = "top_k",
                 params_dtype=torch.float32, routing_format: str = "sorted",
                 device=None):
        super().__init__()
        if router_type == "expert_choice":
            raise NotImplementedError(
                f"router_type 'expert_choice' is not ported yet: {_ITEM_6}")
        if router_type != "top_k":
            raise ValueError(f"unknown router_type {router_type!r}; "
                             f"expected 'top_k' or 'expert_choice'")
        if routing_format == "dense":
            raise NotImplementedError(
                f"routing_format 'dense' ([T, E, C] one-hots, the einsum "
                f"dispatch) is not ported yet: {_ITEM_6}")
        if routing_format not in ("sorted", "sorted_dropless"):
            raise ValueError(f"unknown routing_format {routing_format!r}")
        if jitter_eps > 0.0:
            raise NotImplementedError(
                f"router jitter is not ported yet: {_ITEM_6}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.normalize_topk = normalize_topk
        self.routing_format = routing_format
        self.gate_weight = nn.Parameter(torch.empty(
            hidden_size, num_experts, dtype=params_dtype, device=device))

    def logits(self, tokens):
        """fp32 router logits [T, E] of tokens [T, h]."""
        return tokens.float() @ self.gate_weight.float()

    def forward(self, tokens, routing_format=None) -> SortedRouting:
        """``routing_format`` overrides the module's own for this call, as
        JAX's SwitchMLP builds its router with the format its dispatch
        reads."""
        fmt = routing_format or self.routing_format
        if fmt not in ("sorted", "sorted_dropless"):
            raise ValueError(f"unknown routing_format {fmt!r}")
        logits = self.logits(tokens)
        if fmt == "sorted_dropless":
            return compute_routing_sorted(logits, self.top_k, None,
                                          self.normalize_topk)
        cap = expert_capacity(tokens.shape[0], self.num_experts, self.top_k,
                              self.capacity_factor)
        return compute_routing_sorted(logits, self.top_k, cap,
                                      self.normalize_topk)
