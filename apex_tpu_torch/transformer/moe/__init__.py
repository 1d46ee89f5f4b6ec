"""Mixture of experts at expert-parallel world size 1: top-k routing in
the sorted formulation and the Switch MLP with the ragged and scatter
dispatches (counterpart of ``apex_tpu/transformer/moe``)."""

from apex_tpu_torch.transformer.moe.layer import ExpertMLP, SwitchMLP
from apex_tpu_torch.transformer.moe.router import (
    SortedRouting,
    TopKRouter,
    compute_routing_sorted,
    expert_capacity,
)

__all__ = ["ExpertMLP", "SortedRouting", "SwitchMLP", "TopKRouter",
           "compute_routing_sorted", "expert_capacity"]
