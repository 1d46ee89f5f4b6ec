"""The model-parallel grid over ``torch.distributed`` ranks.

Counterpart of ``apex_tpu/transformer/parallel_state.py`` (reference
apex/transformer/parallel_state.py): :func:`initialize_model_parallel`
lays the ranks of the default process group out as a (pp, dp, tp) grid
with tp varying fastest, ``np.arange(world).reshape(pp, dp, tp)``, as the
JAX package lays its devices out in its mesh, so the tensor-parallel
ranks of a group are adjacent. It makes one process group for each row of
the tp axis and each column of the dp axis, and binds the axis names
``"tp"`` and ``"dp"`` to this rank's two groups in
:mod:`apex_tpu_torch.parallel.groups`, where the collectives of
``tensor_parallel`` and ``DistributedDataParallel`` look them up.

Every rank must call :func:`initialize_model_parallel`: each group is
made by every rank, in the same order, the groups it is not in too.

With no grid initialized the tp world size is 1 and every getter answers
for a single rank, so the paths that do not shard run unchanged. Pipeline
parallelism (pp > 1, virtual pipelines), context and expert parallelism
come with ROADMAP item 6 and raise here.
"""

import contextlib
from typing import Optional

import numpy as np
import torch.distributed as dist

from apex_tpu_torch.parallel import groups

DATA_PARALLEL_AXIS = "dp"
TENSOR_PARALLEL_AXIS = "tp"

_GRID = None  # dict: world sizes, this rank's coordinates and groups


def _later(what):
    return NotImplementedError(
        f"{what} comes with pipeline, expert and context parallelism, "
        f"ROADMAP queue A item 6")


def rank_grid(world_size: int, tensor_model_parallel_size_: int = 1,
              pipeline_model_parallel_size_: int = 1) -> np.ndarray:
    """The global ranks as the (pp, dp, tp) grid, tp fastest. Raises
    RuntimeError when the world does not divide."""
    tp, pp = tensor_model_parallel_size_, pipeline_model_parallel_size_
    if tp < 1 or pp < 1 or world_size % (tp * pp):
        raise RuntimeError(
            f"world_size ({world_size}) is not divisible by "
            f"tensor_model_parallel_size ({tp}) x "
            f"pipeline_model_parallel_size ({pp})")
    return np.arange(world_size).reshape(pp, world_size // (tp * pp), tp)


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        context_parallel_size_: int = 1,
        expert_model_parallel_size_: int = 1):
    """Build the (pp, dp, tp) grid over the default process group
    (:func:`apex_tpu_torch.parallel.multiproc.initialize_distributed`
    first) and bind ``"tp"`` and ``"dp"`` to this rank's groups, which
    take the default group's backend. Returns the grid of global ranks."""
    global _GRID
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "initialize_model_parallel: no torch.distributed process group "
            "is initialized; call apex_tpu_torch.parallel.multiproc."
            "initialize_distributed() first")
    if virtual_pipeline_model_parallel_size_ is not None:
        if pipeline_model_parallel_size_ < 2:
            raise RuntimeError(
                "pipeline-model-parallel size should be greater than 2 with "
                "interleaved schedule")
        raise _later("the interleaved (virtual) pipeline schedule")
    if pipeline_model_parallel_size_ > 1:
        raise _later("pipeline parallelism (pp > 1)")
    if context_parallel_size_ != 1:
        raise _later("context parallelism (cp > 1)")
    if expert_model_parallel_size_ != 1:
        raise _later("expert parallelism (ep > 1)")
    grid = rank_grid(dist.get_world_size(), tensor_model_parallel_size_)
    if _GRID is not None:
        destroy_model_parallel()
    rank = dist.get_rank()
    pp, dp, tp = grid.shape
    mine = {}
    # every rank makes every group, in the same order
    for p in range(pp):
        for d in range(dp):
            ranks = grid[p, d, :].tolist()
            group = dist.new_group(ranks)
            if rank in ranks:
                mine["tp"] = group
        for t in range(tp):
            ranks = grid[p, :, t].tolist()
            group = dist.new_group(ranks)
            if rank in ranks:
                mine["dp"] = group
    where = np.argwhere(grid == rank)[0]
    _GRID = dict(pp=pp, dp=dp, tp=tp, coords=tuple(int(c) for c in where),
                 tp_group=mine["tp"], dp_group=mine["dp"],
                 tp_src=int(grid[where[0], where[1], 0]))
    groups.register_axis(TENSOR_PARALLEL_AXIS, mine["tp"], grid=True)
    groups.register_axis(DATA_PARALLEL_AXIS, mine["dp"], grid=True)
    return grid


@contextlib.contextmanager
def unsharded():
    """Inside, the grid's world sizes and ranks read as a single rank's,
    so that modules built there size their weights for tp = 1: the tp = 1
    twin of a sharded model whose weights are drawn and then split per
    rank (:func:`apex_tpu_torch.models.generation.init_params_tp`). The
    process groups stay bound; nothing built inside is meant to run."""
    global _GRID
    saved, _GRID = _GRID, None
    try:
        yield
    finally:
        _GRID = saved


def model_parallel_is_initialized() -> bool:
    return _GRID is not None


def destroy_model_parallel():
    """Unbind the grid's axes and forget it (the process groups stay until
    the default group is destroyed)."""
    global _GRID
    if _GRID is not None:
        groups.register_axis(TENSOR_PARALLEL_AXIS, None, grid=True)
        groups.register_axis(DATA_PARALLEL_AXIS, None, grid=True)
    _GRID = None


def get_tensor_model_parallel_group():
    if _GRID is None:
        raise RuntimeError("tensor model parallel group is not initialized")
    return _GRID["tp_group"]


def get_data_parallel_group():
    if _GRID is None:
        raise RuntimeError("data parallel group is not initialized")
    return _GRID["dp_group"]


# ----------------------------------------------------------- world sizes

def get_tensor_model_parallel_world_size() -> int:
    return 1 if _GRID is None else _GRID["tp"]


def get_pipeline_model_parallel_world_size() -> int:
    return 1 if _GRID is None else _GRID["pp"]


def get_data_parallel_world_size() -> int:
    return 1 if _GRID is None else _GRID["dp"]


def get_model_parallel_world_size() -> int:
    return (get_tensor_model_parallel_world_size()
            * get_pipeline_model_parallel_world_size())


# ----------------------------------------------------------------- ranks

def get_tensor_model_parallel_rank() -> int:
    return 0 if _GRID is None else _GRID["coords"][2]


def get_data_parallel_rank() -> int:
    return 0 if _GRID is None else _GRID["coords"][1]


def get_pipeline_model_parallel_rank() -> int:
    return 0 if _GRID is None else _GRID["coords"][0]


def get_tensor_model_parallel_src_rank() -> int:
    """The global rank of tp rank 0 in this rank's tp group (the source of
    :func:`~apex_tpu_torch.transformer.tensor_parallel.broadcast_data`); 0
    with no grid."""
    return 0 if _GRID is None else _GRID["tp_src"]


def refuse_tensor_parallel(what: str) -> None:
    """Raise where a tp grid of more than one rank is bound: ``what``
    still lays its weights out unsharded. Its one user is the
    mixture-of-experts layer, whose expert split at tp > 1 is expert
    parallelism's (ROADMAP queue A item 6)."""
    if get_tensor_model_parallel_world_size() > 1:
        raise NotImplementedError(
            f"{what} at tensor-parallel size "
            f"{get_tensor_model_parallel_world_size()} comes with expert "
            f"parallelism, ROADMAP queue A item 6: its expert split is "
            f"expert parallelism's, not a tp split")
