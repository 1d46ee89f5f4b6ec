"""Non-finite step guard: skip poisoned optimizer steps on the device.

Counterpart of ``apex_tpu/resilience/guard.py``, with its state, counters,
events and escalation. One NaN microbatch poisons every parameter once
the optimizer commits it. :func:`guarded_update` keeps the step on the
card with no host synchronisation:

- the non-finite flag comes from K7's non-finite counts over the
  gradients (:func:`nonfinite_flag`), is OR'd with amp's ``found_inf``
  and over the replicas with one fp32 all-reduce
  (``parallel.distributed.all_reduce_flag``);
- the optimizer's own state (masters, moments, its device step count)
  is protected by handing the global flag to the fused optimizers as
  their device ``found_inf``: their kernels skip every write where it is
  > 0 (``optimizers/_base.py``, ``kernels/optim.py``), so ``opt_update``
  takes the flag as its third argument;
- any state the optimizer does not own (the DDP error-feedback residual,
  a step counter of the caller's) goes in ``state`` and is reverted with
  ``torch.where`` on the device, as the JAX package reverts with
  ``jnp.where``;
- the loss scaler is NOT reverted: its backoff on the global flag is the
  reaction to the overflow, so a ``scaler``/``scaler_state`` pair always
  commits.

:class:`GuardState` carries the consecutive-skip streak on the device;
:func:`check_guard` is the one host read (three int32s), lands the
``guard/steps_skipped`` counter and ``guard/consecutive_skips`` gauge,
dumps the flight recorder's post-mortem on a skip and raises
:class:`NonFiniteError` after K consecutive skips. :func:`guarded_call`
runs a step under the OOM post-mortem handler
(``telemetry.memory.oom_guard``).
"""

import os
from typing import Any, Callable, NamedTuple, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.telemetry import trace as _telemetry_trace
from apex_tpu_torch.telemetry.registry import get_registry

ENV_MAX_SKIPS = "APEX_TPU_GUARD_MAX_SKIPS"
DEFAULT_MAX_CONSECUTIVE_SKIPS = 3


class NonFiniteError(RuntimeError):
    """Raised host-side when non-finite gradients persist past the
    consecutive-skip budget (or when every slot of a serving batch goes
    non-finite at once)."""


class GuardState(NamedTuple):
    """Skip accounting on the device (three int32 0-d tensors)."""

    consecutive_skips: torch.Tensor  # current skip streak
    total_skips: torch.Tensor        # lifetime skipped steps
    last_skipped: torch.Tensor       # 1 iff the latest step skipped


def init_guard_state(device=None) -> GuardState:
    device = torch.device("cpu") if device is None else torch.device(device)
    return GuardState(*(torch.zeros((), dtype=torch.int32, device=device)
                        for _ in range(3)))


def _float_leaves(tree):
    return [l for l in _tree.leaves(tree)
            if isinstance(l, torch.Tensor) and l.is_floating_point()
            and l.numel() > 0]


def nonfinite_flag(tree, device=None) -> torch.Tensor:
    """fp32 0-d: 1.0 iff any floating leaf of ``tree`` holds a non-finite
    value — K7's non-finite count over the leaves, one group (one launch
    a 64 tensors on the card), with no host synchronisation."""
    from apex_tpu_torch.kernels.stats import multi_tensor_stats

    leaves = _float_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32, device=device)
    _, counts = multi_tensor_stats(leaves, [0] * len(leaves), 1)
    return (counts[0, 1] > 0).to(torch.float32)


def flag_from_stats(stats) -> torch.Tensor:
    """The non-finite flag of a ``tree_stats`` result (its ``nonfinite``
    column, no second pass over the tensors)."""
    from apex_tpu_torch.telemetry import numerics

    table = numerics.stats_table(stats)
    return (table[:, numerics.NONFINITE].sum() > 0).to(torch.float32)


def guarded_update(grads, opt_update: Callable[[Any, Any, torch.Tensor], Any],
                   state, guard_state: GuardState, *, axis_name=None,
                   flag=None, found_inf=None, scaler=None,
                   scaler_state=None, recorder=None, recorder_state=None,
                   stats=None, step=None):
    """Run ``opt_update(grads, state, global_flag)`` and commit its result
    only where the gradients are globally finite; ``state`` stays as it
    was otherwise.

    Args:
      grads: the gradient tree the flag is derived from (check the local
        pre-compression gradients).
      opt_update: ``(grads, state, flag) -> new_state``: hands ``flag``
        (fp32, one element, > 0 = skip) to the fused optimizers as their
        ``found_inf`` and returns ``state``'s candidate, the same tree
        structure.
      state: the tree to protect that the optimizer does not own
        (reverted by ``torch.where``).
      guard_state: :class:`GuardState` from the previous step.
      axis_name: axis (process group) to OR the flag over; None for one
        replica.
      flag: optionally the local flag (fp32, > 0 = skip), in place of
        deriving it.
      found_inf: amp's overflow flag, OR'd in.
      scaler / scaler_state: the scaler's update runs on the global flag
        and its new state is returned third (committed on a skip too).
      recorder / recorder_state: this step's statistics land in the
        flight recorder's ring (unconditionally); the ring's state is
        returned last.
      stats: optional precomputed ``tree_stats`` of the local gradients
        (the DDP ``numerics=`` knob's); the flag is then read from them.
      step: the step number stamped into the ring row (default its
        lifetime record count).

    Returns ``(new_state, new_guard_state)``, plus ``new_scaler_state``
    with a scaler, plus ``recorder_state`` (last) with a recorder. No
    host synchronisation.
    """
    with _telemetry_trace.span("guard/update", axis=str(axis_name),
                               scaled=scaler is not None):
        device = guard_state.consecutive_skips.device
        if recorder is not None and stats is None:
            from apex_tpu_torch.telemetry import numerics as _numerics

            stats = _numerics.tree_stats(grads,
                                         prefix_depth=recorder.prefix_depth)
        if flag is not None:
            local = torch.as_tensor(flag, dtype=torch.float32).reshape(())
        elif stats is not None:
            local = flag_from_stats(stats)
        else:
            local = nonfinite_flag(grads, device)
        local = local.to(device)
        if found_inf is not None:
            local = torch.maximum(
                local, (found_inf.reshape(()).to(device) > 0).to(
                    torch.float32))
        if axis_name is not None:
            from apex_tpu_torch.parallel.distributed import all_reduce_flag

            global_flag = all_reduce_flag(local, axis_name).reshape(())
        else:
            global_flag = local
        skip = global_flag > 0

        candidate = opt_update(grads, state, global_flag.reshape(1))
        if _tree.structure(candidate) != _tree.structure(state):
            raise ValueError(
                "guarded_update: opt_update returned a different tree "
                "structure than state — the skip path could not revert "
                f"it ({_tree.structure(candidate)} vs "
                f"{_tree.structure(state)})")
        new_state = _tree.tree_map(
            lambda old, new: torch.where(skip, old, new)
            if isinstance(old, torch.Tensor) else new, state, candidate)

        skip_i = skip.to(torch.int32)
        new_guard = GuardState(
            consecutive_skips=torch.where(
                skip, guard_state.consecutive_skips + 1,
                torch.zeros_like(guard_state.consecutive_skips)),
            total_skips=guard_state.total_skips + skip_i,
            last_skipped=skip_i,
        )
        outs = (new_state, new_guard)
        if scaler is not None:
            if scaler_state is None:
                raise ValueError("guarded_update: scaler given without "
                                 "scaler_state")
            outs = outs + (scaler.update(scaler_state,
                                         global_flag.reshape(1)),)
        if recorder is not None:
            if recorder_state is None:
                raise ValueError("guarded_update: recorder given without "
                                 "recorder_state")
            # unconditional: the ring keeps the poisoned step's statistics
            outs = outs + (recorder.record(
                recorder_state,
                recorder_state.cursor if step is None else step, stats),)
        return outs


def guarded_call(fn, *args, oom_dir=None, registry=None, labels=None,
                 **kwargs):
    """Run one step under the OOM post-mortem handler: an out-of-memory
    error (``torch.cuda.OutOfMemoryError``, or
    ``faults.inject_alloc_failure``'s synthetic one) writes
    ``memory-postmortem-rank<N>.json`` into ``oom_dir`` (default
    ``$APEX_TPU_MEMORY_DIR`` -> telemetry dir -> CWD), empties the
    allocator's cache and re-raises as
    :class:`~apex_tpu_torch.telemetry.memory.HBMExhaustedError`.
    ``labels`` (``{"masters": ..., ...}``) attribute census rows to the
    caller's trees. Every other exception passes through untouched."""
    from apex_tpu_torch.telemetry import memory as _memory

    with _memory.oom_guard(oom_dir, registry=registry, labels=labels):
        return fn(*args, **kwargs)


def check_guard(guard_state: GuardState,
                max_consecutive_skips: Optional[int] = None, *,
                registry=None, recorder=None, recorder_state=None,
                postmortem_dir=None) -> int:
    """Host-side escalation and telemetry poll for the guard: one copy of
    the three :class:`GuardState` scalars to the host, the
    ``guard/steps_skipped`` counter and ``guard/consecutive_skips`` gauge
    reconciled with them, a flight-recorder post-mortem on a skipped step
    (with ``recorder`` + ``recorder_state``), and :class:`NonFiniteError`
    once the streak reaches ``max_consecutive_skips`` (default
    ``$APEX_TPU_GUARD_MAX_SKIPS`` or 3), naming the first module prefix
    that went non-finite. Returns the current consecutive-skip count."""
    if max_consecutive_skips is None:
        max_consecutive_skips = int(
            os.environ.get(ENV_MAX_SKIPS, str(DEFAULT_MAX_CONSECUTIVE_SKIPS)))
    consecutive, total, last = (int(v) for v in torch.stack(
        [guard_state.consecutive_skips, guard_state.total_skips,
         guard_state.last_skipped]).cpu().tolist())
    reg = registry or get_registry()
    if reg.enabled:
        counter = reg.counter("guard/steps_skipped")
        # counters only go up; reconcile to the device-side total so
        # check_guard may be called every N steps without undercounting
        delta = total - counter.value
        if delta > 0:
            counter.inc(delta)
        reg.gauge("guard/consecutive_skips").set(consecutive)
        if last:
            reg.event("guard", "step_skipped", consecutive=consecutive,
                      total=total)
    escalate = consecutive >= max_consecutive_skips > 0
    postmortem = None
    if recorder is not None and recorder_state is not None \
            and (last or escalate):
        postmortem = recorder.dump_postmortem(
            recorder_state, postmortem_dir,
            reason="escalation" if escalate else "step_skipped",
            registry=reg,
            extra={"consecutive_skips": consecutive,
                   "total_skips": total})
    if escalate:
        if reg.enabled:
            reg.event("guard", "escalate", consecutive=consecutive,
                      total=total, limit=max_consecutive_skips)
        culprit = ""
        if postmortem is not None:
            prefix = postmortem.get("first_nonfinite_prefix")
            if prefix:
                culprit = (
                    f" Flight record: first non-finite stats in module "
                    f"prefix '{prefix}' at step "
                    f"{postmortem.get('first_nonfinite_step')} "
                    f"(post-mortem: {postmortem.get('path')}).")
            elif postmortem.get("path"):
                culprit = (f" Flight record dumped to "
                           f"{postmortem['path']}.")
        raise NonFiniteError(
            f"{consecutive} consecutive optimizer steps skipped on "
            f"non-finite gradients (limit {max_consecutive_skips}; "
            f"{total} skipped in total) — the run is diverging, not "
            f"hitting one bad batch. Inspect the data pipeline / loss "
            f"scale; restore from the last verified checkpoint."
            + culprit)
    return consecutive
