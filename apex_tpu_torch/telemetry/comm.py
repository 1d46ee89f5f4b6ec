"""Collective accounting: measured per-call payload bytes.

Counterpart of ``apex_tpu/telemetry/comm.py``, with its counters and its
``collective`` event. ``record_collective`` is called at the collective
call sites (``parallel/distributed.py``'s all-reduce and flag reduction,
the ``parallel/compression.py`` paths) with the payload the op ships:
element count, dtype, axis. The port's collectives run eagerly, so a
record lands once per call, which is once per step for a step that makes
the call once. Payloads are recorded at their semantic wire width (the
int4 payload at 4 bits an element, as the JAX package records it).

Ring wire model (bytes each replica transmits, ``w`` = axis size):
  psum (allreduce)   2*(w-1)/w * payload      reduce-scatter + all-gather
  psum_scatter       (w-1)/w   * payload
  all_gather         (w-1)     * shard_bytes  == (w-1)/w * full
  pmax / psum_small  2*(w-1)/w * payload      (scale exchanges)
"""

import torch

from apex_tpu_torch.telemetry.registry import get_registry

# ops whose ``payload`` argument is the per-replica *shard*
_SHARD_OPS = {"all_gather"}
# allreduce-shaped ops: two ring phases
_TWO_PHASE_OPS = {"psum", "pmax", "pmin", "all_reduce"}
# point-to-point shifts: every rank ships its whole payload once
_FULL_OPS = {"ppermute", "collective_permute"}


def axis_label(axis_name):
    """Canonical event tag for a (possibly tuple) axis name: ``"dp"``,
    ``"data,model"``, ``None`` when no axis was named (a process group
    passed as itself is tagged ``"group"``)."""
    if axis_name is None:
        return None
    if isinstance(axis_name, (tuple, list)):
        return ",".join(str(a) for a in axis_name) or None
    if not isinstance(axis_name, str):
        return "group"
    return axis_name


def axis_world(axis_name):
    """The number of ranks of ``axis_name``'s process group; 1 when no
    group is bound (the single-process paths)."""
    from apex_tpu_torch.parallel import groups

    try:
        if isinstance(axis_name, (tuple, list)):
            n = 1
            for a in axis_name:
                n *= groups.axis_size(a)
            return int(n)
        return int(groups.axis_size(axis_name))
    except Exception:
        return 1


def wire_bytes(op, payload_bytes, world):
    """Ring-model bytes each replica transmits for one collective."""
    if world <= 1:
        return 0.0
    if op in _TWO_PHASE_OPS:
        return 2.0 * (world - 1) / world * payload_bytes
    if op in _SHARD_OPS:
        return float((world - 1) * payload_bytes)
    if op in _FULL_OPS:
        return float(payload_bytes)
    # psum_scatter and anything one-phase
    return (world - 1) / world * payload_bytes


def dtype_name(dtype):
    """numpy's name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``), or of a name given as is."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(getattr(dtype, "name", dtype))


def _itemsize(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return torch.empty((), dtype=getattr(torch, dtype_name(dtype))
                       ).element_size()


def record_collective(op, *, elements, dtype, axis_name=None, world=None,
                      mode=None, emulated=False, registry=None,
                      bits=None):
    """Account one collective call (host-side; no device read).

    ``elements``/``dtype`` describe the semantic wire payload; ``world``
    may be passed when the caller already knows the group's size, else
    it is read from ``axis_name``'s group. ``bits`` overrides the dtype's
    width for sub-byte wire formats. No-op when the registry is
    disabled; a world of 1 counts the call with 0 wire bytes."""
    reg = registry or get_registry()
    if not reg.enabled:
        return 0.0
    if world is None:
        world = axis_world(axis_name)
    itemsize = bits / 8.0 if bits else _itemsize(dtype)
    payload = float(elements) * itemsize
    wire = wire_bytes(op, payload, world)
    label = axis_label(axis_name)
    name = dtype_name(dtype)
    reg.counter("comm/calls").inc()
    reg.counter("comm/bytes").inc(wire)
    reg.counter(f"comm/{op}_bytes").inc(wire)
    reg.counter(f"comm/dtype/{name}_bytes").inc(wire)
    if label is not None:
        reg.counter(f"comm/axis/{label}_bytes").inc(wire)
    reg.event("collective", op, elements=int(elements), dtype=name,
              world=int(world), payload_bytes=int(payload),
              wire_bytes=int(round(wire)), mode=mode,
              emulated=bool(emulated) or None,
              bits=int(bits) if bits else None, axis=label)
    return wire
