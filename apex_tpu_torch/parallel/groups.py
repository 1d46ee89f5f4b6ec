"""Mesh axis names -> ``torch.distributed`` process groups.

The JAX package names the replicas a collective runs over by a mesh axis
(``axis_name="dp"``); here the same names resolve, in this one place, to
the process group a collective is given:

- ``"dp"`` is the default group (every rank of
  :func:`~apex_tpu_torch.parallel.multiproc.initialize_distributed`);
- another name must be registered first with :func:`register_axis`;
- a ``ProcessGroup`` passes through as itself (e.g. the group
  :func:`~apex_tpu_torch.parallel.create_syncbn_process_group` returns).

A collective at world size 1 still runs through ``torch.distributed``:
JAX's psum over a one-device axis is a collective too, so nothing is
skipped because the world is 1. Tuple axes (the dp x ep replica sets of
expert parallelism) come with ROADMAP item 6.
"""

import torch.distributed as dist

DEFAULT_AXIS = "dp"

_axes = {}


def register_axis(name: str, group) -> None:
    """Let axis ``name`` resolve to ``group`` (``None`` removes it).
    ``"dp"`` is always the default group."""
    if name == DEFAULT_AXIS:
        raise ValueError(f"axis {DEFAULT_AXIS!r} is the default process "
                         f"group and cannot be registered")
    if group is None:
        _axes.pop(name, None)
    else:
        _axes[name] = group


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
    if axis_name == DEFAULT_AXIS:
        return dist.group.WORLD
    try:
        return _axes[axis_name]
    except KeyError:
        raise ValueError(
            f"axis {axis_name!r} names no process group: only "
            f"{DEFAULT_AXIS!r} (the default group) and the names given to "
            f"register_axis ({sorted(_axes)}) resolve") from None

