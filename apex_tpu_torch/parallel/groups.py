"""Mesh axis names -> ``torch.distributed`` process groups.

The JAX package names the replicas a collective runs over by a mesh axis
(``axis_name="dp"``); here the same names resolve, in this one place, to
the process group a collective is given:

- ``"dp"`` is the default group (every rank of
  :func:`~apex_tpu_torch.parallel.multiproc.initialize_distributed`);
- another name must be registered first with :func:`register_axis`
  (the grid of :mod:`apex_tpu_torch.transformer.parallel_state` also
  points ``"dp"`` at its data-parallel group, with ``grid=True``, until
  the grid is torn down);
- a ``ProcessGroup`` passes through as itself (e.g. the group
  :func:`~apex_tpu_torch.parallel.create_syncbn_process_group` returns).

A collective at world size 1 still runs through ``torch.distributed``:
JAX's psum over a one-device axis is a collective too, so nothing is
skipped because the world is 1. Only the tensor-parallel region ops,
which JAX makes the identity where their axis has size 1, ask
:func:`axis_size` first. Tuple axes (the dp x ep replica sets of expert
parallelism) come with ROADMAP item 6.
"""

import torch.distributed as dist

DEFAULT_AXIS = "dp"

_axes = {}


def register_axis(name: str, group, *, grid: bool = False) -> None:
    """Let axis ``name`` resolve to ``group`` (``None`` removes it).
    ``"dp"`` is the default group; only a model-parallel grid
    (``grid=True``) points it at the grid's data-parallel group, and
    ``None`` gives it back to the default group."""
    if name == DEFAULT_AXIS and not grid:
        raise ValueError(f"axis {DEFAULT_AXIS!r} is the default process "
                         f"group and cannot be registered")
    if group is None:
        _axes.pop(name, None)
    else:
        _axes[name] = group


def axis_size(axis_name) -> int:
    """The number of ranks of ``axis_name``; 1 when no process group is
    initialized or the name is bound to none, as JAX counts an axis that
    is not bound (its region ops are then the identity)."""
    if not isinstance(axis_name, dist.ProcessGroup) and (
            not dist.is_available() or not dist.is_initialized()
            or (axis_name != DEFAULT_AXIS and axis_name not in _axes)):
        return 1
    return dist.get_world_size(axis_group(axis_name))


def axis_rank(axis_name) -> int:
    """This rank's index along ``axis_name``; 0 where :func:`axis_size`
    is 1."""
    if axis_size(axis_name) == 1:
        return 0
    return dist.get_rank(axis_group(axis_name))


def broadcast_object(obj, axis_name):
    """``obj`` (picklable) as rank 0 of ``axis_name``'s group holds it,
    on every rank of the group: how the ranks of one tensor-parallel
    replica agree on what one rank's clock or host state decided."""
    group = axis_group(axis_name)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def axis_group(axis_name):
    """The process group of ``axis_name``. Raises when no default group
    is initialized or the name was never registered."""
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    if isinstance(axis_name, (tuple, list)):
        raise NotImplementedError(
            f"tuple axes {tuple(axis_name)} (dp x ep replica sets) come "
            f"with expert parallelism, ROADMAP item 6")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"axis {axis_name!r}: no torch.distributed process group is "
            f"initialized; call apex_tpu_torch.parallel.multiproc."
            f"initialize_distributed() first")
    group = _axes.get(axis_name)
    if group is None and axis_name == DEFAULT_AXIS:
        group = dist.group.WORLD
    if group is None:
        raise ValueError(
            f"axis {axis_name!r} names no process group: only "
            f"{DEFAULT_AXIS!r} (the default group) and the names given to "
            f"register_axis ({sorted(_axes)}) resolve")
    return group

