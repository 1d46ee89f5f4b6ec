"""Training supervisor: automatic recovery, not just detection.

Counterpart of ``apex_tpu/resilience/supervisor.py``, with its failure
classes, policies, ledger, report and ``recovery`` events. The state it
snapshots, checkpoints and restores is a tree of tensors; a hot
snapshot is a host copy of every tensor (the JAX package's
``jax.device_get``), and a restore hands the step function that host
tree, which it puts back on the card.

The rest of the resilience subsystem is a *detection* stack — the step
guard skips poisoned steps and escalates ``NonFiniteError``, the OOM
guard dies with an attributed ``HBMExhaustedError``, restore rejects
corrupt checkpoints — but every escalation still kills the run, and a
kill loses every step since the last disk checkpoint. The
:class:`Supervisor` closes the loop: it wraps a user step function and
composes the existing primitives into a policy-driven recovery loop,
so the failure classes a long run WILL see each cost a bounded number
of replayed steps instead of the run.

Per failure class (:func:`classify_failure`), a
:class:`RecoveryPolicy` names the reaction:

- ``numerics`` (``NonFiniteError`` escalation) — revert to the latest
  **hot snapshot** and optionally back the loss scale off
  (:func:`loss_scale_backoff`); the poisoned streak is replayed from
  known-good state.
- ``oom`` (``HBMExhaustedError`` / RESOURCE_EXHAUSTED) — revert to the
  hot snapshot (transient fragmentation / shape spike) with an
  ``adjust`` hook for callers that want to shrink the batch.
- ``checkpoint_corrupt`` (``CheckpointCorruptError``, e.g. a torn
  write caught by post-save verification) — restore from the last
  *good* step via ``checkpoint.restore``'s existing fallback chain,
  auditing what was actually loaded through the restore metadata.
- ``preemption`` (polled from a
  :class:`~apex_tpu_torch.resilience.preemption.PreemptionGuard`) — one
  final synchronous checkpoint, then a clean exit the caller can
  resume from (:meth:`Supervisor.restore_from_checkpoint`).
- ``device_loss`` (:class:`~apex_tpu_torch.resilience.faults.DeviceLostError`
  / a runtime ``DEVICE_LOST``) — a **mesh-shrink restart**: the caller's
  ``rebuild(world, host_state, step)`` hook reconstructs the step
  function on the surviving mesh, re-partitioning ZeRO shards via
  ``DistributedFusedAdam.load_state_dict_resharded``.

Two mechanisms make recovery cheap and provable:

1. **Hot snapshots** (:class:`HotSnapshots`): every ``snapshot_every``
   steps the full training state — params, optimizer state including
   the int8 EF residual, RNG, ``GuardState``, flight-recorder ring,
   whatever the caller put in the state pytree — is copied to host RAM
   (one host copy of every tensor). A snapshot restore is a host-memory
   assignment: milliseconds, no disk, and it survives device loss
   because the copy lives on the host. Disk checkpoints remain the
   durable tier below (``checkpoint_every``); the snapshot cadence
   bounds MTTR in steps, the checkpoint cadence bounds loss on a full
   process death.
2. **The step ledger** (:class:`StepLedger`): every applied step and
   every rollback is recorded, with apply order enforced at record
   time — a step applied out of order (silently lost or double-applied
   after a botched restore) raises :class:`LedgerError` immediately,
   and :meth:`StepLedger.verify` replays the whole event log as the
   end-of-run proof that the surviving lineage is exactly
   ``start..final`` with each step applied once.

Restarts are bounded (per-class ``max_restarts`` + a global
``max_restarts_total``) with capped exponential backoff between
attempts; exhaustion raises :class:`RecoveryExhaustedError` chaining
the final failure. Telemetry: ``recovery/restarts`` /
``snapshot_restores`` / ``checkpoint_restores`` / ``mesh_shrinks`` /
``steps_lost`` counters, a per-class ``recovery/cause/<class>``
histogram-by-counter, the ``recovery/mttr_steps`` gauge, and
``recovery`` JSONL events (``failure`` / ``recovered`` / ``gave_up`` /
``snapshot`` / ``preempted_exit``) that ``tools/telemetry_report.py``
rolls up.
"""

import time
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.resilience.faults import DeviceLostError
from apex_tpu_torch.resilience.guard import NonFiniteError
from apex_tpu_torch.telemetry.registry import get_registry
from apex_tpu_torch.telemetry.trace import span, trace_context

# -- failure classes ---------------------------------------------------------


class FailureClass:
    """The failure taxonomy the supervisor routes on (plain strings so
    policies/telemetry/JSON stay trivially serializable)."""

    NUMERICS = "numerics"
    OOM = "oom"
    CHECKPOINT = "checkpoint_corrupt"
    PREEMPTION = "preemption"
    DEVICE_LOSS = "device_loss"
    UNKNOWN = "unknown"

    ALL = (NUMERICS, OOM, CHECKPOINT, PREEMPTION, DEVICE_LOSS, UNKNOWN)


def classify_failure(exc: BaseException) -> str:
    """Map an exception from the supervised step (or the supervisor's
    own checkpoint I/O) to a :class:`FailureClass` constant. Typed
    errors from the resilience/telemetry stack classify exactly, and
    ``torch.cuda.OutOfMemoryError`` is the OOM class; untyped runtime
    errors fall back to the markers in their messages (``DEVICE_LOST``,
    ``RESOURCE_EXHAUSTED``, ``out of memory``)."""
    from apex_tpu_torch.checkpoint import CheckpointCorruptError
    from apex_tpu_torch.telemetry.memory import HBMExhaustedError, \
        is_oom_error

    if isinstance(exc, NonFiniteError):
        return FailureClass.NUMERICS
    if isinstance(exc, DeviceLostError):
        return FailureClass.DEVICE_LOSS
    if isinstance(exc, CheckpointCorruptError):
        return FailureClass.CHECKPOINT
    if isinstance(exc, HBMExhaustedError) or is_oom_error(exc):
        return FailureClass.OOM
    if "DEVICE_LOST" in str(exc):
        return FailureClass.DEVICE_LOSS
    return FailureClass.UNKNOWN


class RecoveryExhaustedError(RuntimeError):
    """The restart budget (per-class or total) ran out; the original
    failure is chained as ``__cause__``. At this point a human (or the
    cluster scheduler) owns the run again."""


class LedgerError(RuntimeError):
    """The step ledger caught a non-monotonic apply — a step silently
    lost or double-applied. This is a supervisor bug surfacing, never
    something to recover from."""


# -- the step ledger ---------------------------------------------------------


class StepLedger:
    """Append-only audit log proving step-application integrity.

    Invariant, enforced at record time: in the *surviving lineage*
    (applies minus rolled-back suffixes), step ``s`` is applied exactly
    when the previous applied step was ``s - 1``. A rollback names the
    step the timeline truncates back to; replayed steps then re-apply
    in order. :meth:`verify` independently replays the event log so the
    proof does not rest on the same counter that enforced it.
    """

    def __init__(self, start_step: int = 0):
        self.start_step = int(start_step)
        self._next = int(start_step)
        self.events = [("start", int(start_step), None)]
        self.applies = 0
        self.rollbacks = 0

    @property
    def next_step(self) -> int:
        """The only step the lineage can legally apply next."""
        return self._next

    def record_apply(self, step: int) -> None:
        step = int(step)
        if step != self._next:
            what = "double-applied" if step < self._next else "lost"
            raise LedgerError(
                f"step {step} applied out of order — the lineage "
                f"expected {self._next} (a step was silently {what})")
        self.events.append(("apply", step, None))
        self._next = step + 1
        self.applies += 1

    def record_rollback(self, to_step: int, cause: Optional[str] = None
                        ) -> int:
        """Truncate the lineage back to ``to_step`` (the next step to
        apply). Returns the number of applied steps rolled back."""
        to_step = int(to_step)
        if not self.start_step <= to_step <= self._next:
            raise LedgerError(
                f"rollback to step {to_step} is outside the lineage "
                f"[{self.start_step}, {self._next}]")
        lost = self._next - to_step
        self.events.append(("rollback", to_step, cause))
        self._next = to_step
        self.rollbacks += 1
        return lost

    def verify(self, expect_next: Optional[int] = None) -> Dict[str, Any]:
        """Replay the event log and prove the lineage: applies strictly
        monotonic, each rollback inside the lineage, final next-step
        equal to ``expect_next`` when given. Raises :class:`LedgerError`
        on any violation; returns the summary dict."""
        cur = None
        for kind, step, _ in self.events:
            if kind == "start":
                cur = step
            elif kind == "apply":
                if step != cur:
                    raise LedgerError(
                        f"ledger replay: apply({step}) where {cur} was "
                        f"expected")
                cur = step + 1
            elif kind == "rollback":
                if not self.start_step <= step <= cur:
                    raise LedgerError(
                        f"ledger replay: rollback({step}) outside "
                        f"[{self.start_step}, {cur}]")
                cur = step
        if cur != self._next:
            raise LedgerError(
                f"ledger replay ended at {cur}, counter says {self._next}")
        if expect_next is not None and cur != int(expect_next):
            raise LedgerError(
                f"lineage ends at step {cur}, expected {int(expect_next)}"
                " — steps were lost")
        return {"monotonic": True, "start_step": self.start_step,
                "next_step": cur, "applies": self.applies,
                "rollbacks": self.rollbacks, "events": len(self.events)}


# -- policies ---------------------------------------------------------------


class RecoveryPolicy:
    """What to do when a failure of one class lands.

    ``action``: ``"snapshot_restore"`` (revert to the latest hot
    snapshot; falls back to ``checkpoint_restore`` when no snapshot
    exists yet), ``"checkpoint_restore"`` (the disk fallback chain),
    ``"mesh_shrink"`` (rebuild on a smaller world via the supervisor's
    ``rebuild`` hook), or ``"reraise"`` (no recovery — the class is
    fatal by policy).

    ``max_restarts`` bounds recoveries of this class per run;
    ``backoff_base_s``/``backoff_cap_s`` shape the capped exponential
    wait before re-dispatch. ``adjust`` (``(host_state, exc) ->
    host_state``) edits the restored state before replay — the
    loss-scale backoff hook for numerics, a batch-shrink hook for OOM.
    ``shrink_to`` pins the post-loss world size for ``mesh_shrink``
    (default: the error's own ``shrink_to``, else ``world // 2``)."""

    ACTIONS = ("snapshot_restore", "checkpoint_restore", "mesh_shrink",
               "reraise")

    def __init__(self, action: str, *, max_restarts: int = 3,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 adjust: Optional[Callable[[Any, BaseException], Any]] = None,
                 shrink_to: Optional[int] = None):
        if action not in self.ACTIONS:
            raise ValueError(f"RecoveryPolicy: unknown action {action!r} "
                             f"(want one of {self.ACTIONS})")
        self.action = action
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.adjust = adjust
        self.shrink_to = shrink_to

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff for the ``attempt``-th recovery
        of this class (1-based)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2 ** max(attempt - 1, 0)))

    def __repr__(self):
        return (f"RecoveryPolicy({self.action!r}, "
                f"max_restarts={self.max_restarts})")


def loss_scale_backoff(key: str = "loss_scale", factor: float = 0.5,
                       min_scale: float = 1.0):
    """An ``adjust`` hook for the numerics policy: multiply the state's
    ``key`` leaf (when present) by ``factor``, flooring at
    ``min_scale`` — replaying the poisoned stretch at a lower loss
    scale is the reaction that actually removes an overflow cause,
    where a bare replay would re-diverge."""
    def adjust(host_state, exc):
        if isinstance(host_state, dict) and key in host_state:
            cur = torch.as_tensor(host_state[key], dtype=torch.float32)
            host_state = dict(host_state)
            host_state[key] = torch.clamp(cur * factor, min=min_scale)
        return host_state

    return adjust


def default_policies() -> Dict[str, RecoveryPolicy]:
    """The per-class defaults of the failure matrix. Callers
    override per class by passing ``policies={cls: RecoveryPolicy(...)}``
    to :class:`Supervisor` (missing classes keep these)."""
    return {
        FailureClass.NUMERICS: RecoveryPolicy(
            "snapshot_restore", max_restarts=3,
            adjust=loss_scale_backoff()),
        FailureClass.OOM: RecoveryPolicy("snapshot_restore",
                                         max_restarts=3),
        FailureClass.CHECKPOINT: RecoveryPolicy("checkpoint_restore",
                                                max_restarts=3),
        FailureClass.DEVICE_LOSS: RecoveryPolicy("mesh_shrink",
                                                 max_restarts=2),
        FailureClass.UNKNOWN: RecoveryPolicy("reraise", max_restarts=0),
    }


# -- hot snapshots -----------------------------------------------------------


class Snapshot:
    """One host-RAM copy of the full training state, taken *entering*
    ``step`` (restoring it means the next step to run is ``step``)."""

    __slots__ = ("step", "state", "world")

    def __init__(self, step, state, world=None):
        self.step = int(step)
        self.state = state
        self.world = world


def host_copy(state):
    """Every tensor of ``state`` copied to the host (CPU tensors cloned),
    in the same containers: the port's ``jax.device_get``."""
    return _tree.tree_map(
        lambda x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else x, state)


class HotSnapshots:
    """A bounded stack of host-RAM state copies — the fast recovery
    tier above disk checkpoints. ``take`` copies every tensor of the
    state to the host (blocking, so the step that follows may overwrite
    the card's copies); ``latest``/``restore`` cost a container copy, no
    device transfer — the step function puts the tensors back."""

    def __init__(self, keep: int = 2):
        if keep < 1:
            raise ValueError(f"HotSnapshots: keep must be >= 1, got {keep}")
        self.keep = int(keep)
        self._snaps = []

    def take(self, step: int, state, world=None) -> Snapshot:
        snap = Snapshot(step, host_copy(state), world)
        self._snaps.append(snap)
        del self._snaps[:-self.keep]
        return snap

    def latest(self) -> Optional[Snapshot]:
        return self._snaps[-1] if self._snaps else None

    def clear(self) -> None:
        self._snaps.clear()

    def __len__(self):
        return len(self._snaps)

    @staticmethod
    def copy_state(snap: Snapshot):
        """A fresh container tree over the snapshot's (immutable host)
        arrays, so an ``adjust`` hook editing the restored state never
        mutates the snapshot itself."""
        return _tree.tree_map(lambda x: x, snap.state)


# -- world-size helpers (2-D (data, model) meshes carry tuple worlds) -------


def _canon_world(world):
    """An int dp world stays an int; a ``(dp, tp)`` (or deeper) mesh
    shape becomes a tuple of ints — the form the ``rebuild`` hook and
    the elastic 2-D ZeRO reshard consume."""
    if isinstance(world, (tuple, list)):
        return tuple(int(w) for w in world)
    return int(world)


def _world_size(world):
    """Total replica count of an int or tuple world (telemetry gauge)."""
    if isinstance(world, (tuple, list)):
        n = 1
        for w in world:
            n *= int(w)
        return n
    return int(world)


def _half_world(world):
    """The default shrink target when neither the error nor the policy
    pins one: halve an int world; on a tuple world halve the LAST axis
    whose size exceeds 1, falling back leftward. Axis order in the
    tuple therefore IS the give-up policy: ``(data, model)`` halves
    the model axis first (``(2, 4) -> (2, 2)``); a 3-D
    ``(data, model, pipe)`` world gives up the pipe axis first
    (``(2, 2, 2) -> (2, 2, 1)``), the model axis second — pipeline
    bubbles are the cheapest capability to lose, and the elastic 3-D
    ZeRO table (:func:`~apex_tpu_torch.contrib.optimizers.
    distributed_fused_adam.reshard_zero_state_3d`) restores onto the
    shrunk topology bit-identically."""
    if isinstance(world, (tuple, list)):
        axes = [int(w) for w in world]
        for i in reversed(range(len(axes))):
            if axes[i] > 1:
                axes[i] = max(1, axes[i] // 2)
                return tuple(axes)
        return tuple(axes)
    return max(1, (world or 2) // 2)


def _world_json(world):
    """Tuples -> lists so the topology record stays JSON-serializable."""
    if isinstance(world, (tuple, list)):
        return [int(w) for w in world]
    return int(world)


# -- the supervisor ----------------------------------------------------------


class Supervisor:
    """Run ``step_fn`` under automatic failure recovery.

    ``step_fn(state, step) -> new_state`` is the user's whole training
    step — dispatch, ``check_guard`` escalation poll, anything that can
    raise. ``state`` is one pytree holding EVERYTHING a restore must
    bring back (params, optimizer state incl. the EF residual, RNG,
    ``GuardState``, flight-recorder ring): the supervisor snapshots,
    checkpoints, and restores it as a unit.

    Knobs: ``snapshot_every`` / ``snapshot_keep`` (hot-snapshot tier),
    ``checkpoint_dir`` / ``checkpoint_every`` / ``keep_last_n``
    (durable tier; also the preemption exit target), ``policies``
    (per-class overrides merged over :func:`default_policies`),
    ``max_restarts_total`` (global cap over all classes),
    ``preemption_guard`` (a
    :class:`~apex_tpu_torch.resilience.preemption.PreemptionGuard` polled at
    every step boundary), ``rebuild(world, host_state, step) ->
    (step_fn, state)`` (the mesh-shrink hook — re-partition ZeRO
    shards with ``load_state_dict_resharded`` in there), ``topology``
    (recorded in every checkpoint so an elastic restore knows the
    writing world size), ``sleep`` (injectable backoff clock for
    tests).

    :meth:`run` returns the report dict (exit reason, restart/cause
    accounting, MTTR, goodput ratio, the verified ledger summary);
    the live state stays at :attr:`state`.
    """

    def __init__(self, step_fn: Callable[[Any, int], Any], state, *,
                 policies: Optional[Dict[str, RecoveryPolicy]] = None,
                 snapshot_every: int = 10, snapshot_keep: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 keep_last_n: int = 3,
                 max_restarts_total: int = 16,
                 preemption_guard=None,
                 rebuild: Optional[Callable[[int, Any, int], Any]] = None,
                 world: Optional[int] = None,
                 topology: Optional[Dict[str, Any]] = None,
                 start_step: int = 0,
                 registry=None,
                 snapshot_ok: Optional[Callable[[Any], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._step_fn = step_fn
        self.state = state
        self.policies = dict(default_policies())
        self.policies.update(policies or {})
        self.snapshot_every = int(snapshot_every)
        self.snapshots = HotSnapshots(keep=snapshot_keep)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = (int(checkpoint_every)
                                 if checkpoint_every else None)
        self.keep_last_n = keep_last_n
        self.max_restarts_total = int(max_restarts_total)
        self.preemption = preemption_guard
        self.rebuild = rebuild
        # int for a 1-D dp mesh, a (data, model) tuple for a 2-D one —
        # the shrink default halves the model axis first (_half_world)
        self.world = None if world is None else _canon_world(world)
        self.topology = dict(topology) if topology else None
        self.step = int(start_step)
        self.ledger = StepLedger(start_step)
        self._registry = registry
        # "don't snapshot a state you wouldn't want to restore": e.g.
        # reject states whose GuardState shows a live skip streak — a
        # snapshot taken mid-streak freezes the skipped (uncommitted)
        # steps out of the lineage, so the post-recovery replay could
        # never match the clean run
        self.snapshot_ok = snapshot_ok
        self._sleep = sleep
        # accounting
        self.restarts = 0
        self.restarts_by_class = {c: 0 for c in FailureClass.ALL}
        self.causes = {}
        self.snapshot_restores = 0
        self.checkpoint_restores = 0
        self.mesh_shrinks = 0
        self.steps_lost = 0
        self.dispatches = 0
        self.last_restore_meta = None

    # -- telemetry ------------------------------------------------------

    def _reg(self):
        return self._registry or get_registry()

    def _event(self, name, **fields):
        reg = self._reg()
        if reg.enabled:
            reg.event("recovery", name, **fields)

    def _count(self, name, amount=1):
        reg = self._reg()
        if reg.enabled:
            reg.counter(name).inc(amount)

    # -- durable tier ---------------------------------------------------

    def save_checkpoint(self) -> str:
        """One verified disk checkpoint of the current state at the
        current step (the durable tier; also the preemption exit).
        Raises ``CheckpointCorruptError`` when the landed bytes fail
        verification (e.g. a torn write) — which :meth:`run` treats as
        a recoverable ``checkpoint_corrupt`` failure."""
        from apex_tpu_torch import checkpoint as _ckpt

        if self.checkpoint_dir is None:
            raise ValueError("Supervisor: no checkpoint_dir configured")
        payload = {"state": self.state,
                   "supervisor": {"step": self.step,
                                  "topology": self.topology or {}}}
        path = _ckpt.save(self.checkpoint_dir, self.step, payload)
        _ckpt.verify_checkpoint(path)  # a torn write dies HERE, loudly
        if self.keep_last_n:
            _ckpt._prune_old_steps(self.checkpoint_dir, self.keep_last_n)
        self._event("checkpoint_saved", step=self.step, path=path)
        return path

    def restore_from_checkpoint(self):
        """Load the newest *good* checkpoint through the fallback chain,
        reset the run to its step, and return the restore metadata
        (settled step, rejected steps) for the audit trail. Used both
        for in-run corruption recovery and for resuming a fresh
        process after a preemption exit."""
        from apex_tpu_torch import checkpoint as _ckpt

        if self.checkpoint_dir is None:
            raise ValueError("Supervisor: no checkpoint_dir configured")
        payload, meta = _ckpt.restore(self.checkpoint_dir,
                                      with_metadata=True)
        step = int(payload.get("supervisor", {}).get(
            "step", meta["settled_step"]))
        saved_topo = payload.get("supervisor", {}).get("topology") or None
        if isinstance(saved_topo, dict):
            saved_topo = {k: int(v) if isinstance(v, torch.Tensor) else v
                          for k, v in saved_topo.items()}
        self.state = payload["state"]
        if step <= self.ledger.next_step:
            lost = self.ledger.record_rollback(step,
                                               cause="checkpoint_restore")
        else:
            # a fresh process resuming a previous run's checkpoint: the
            # lineage restarts at the restored step
            self.ledger = StepLedger(step)
            lost = 0
        self.step = step
        self.steps_lost += lost
        self._last_restore_lost = lost
        self.last_restore_meta = meta
        if saved_topo and self.topology and saved_topo != self.topology:
            warnings.warn(
                f"Supervisor: checkpoint topology {saved_topo} differs "
                f"from the run's {self.topology} — an elastic "
                "(re-sharded) restore is required; make sure the "
                "rebuild/restore path re-partitioned the shards")
        return meta

    # -- the loop -------------------------------------------------------

    def run(self, num_steps: int) -> Dict[str, Any]:
        """Supervise ``num_steps`` steps (absolute: the loop ends when
        the lineage reaches step ``num_steps``). Returns the report."""
        exit_reason = "completed"
        while self.step < num_steps:
            if self.preemption is not None \
                    and self.preemption.should_checkpoint():
                if self.checkpoint_dir is not None:
                    self.save_checkpoint()
                    self.preemption.mark_saved()
                self.causes[FailureClass.PREEMPTION] = \
                    self.causes.get(FailureClass.PREEMPTION, 0) + 1
                self._count("recovery/cause/preemption")
                self._event("preempted_exit", step=self.step,
                            saved=self.checkpoint_dir is not None)
                exit_reason = "preempted"
                break
            try:
                if self.snapshot_every and \
                        self.step % self.snapshot_every == 0 \
                        and (self.snapshot_ok is None
                             or self.snapshot_ok(self.state)):
                    self.snapshots.take(self.step, self.state, self.world)
                    self._event("snapshot", step=self.step,
                                kept=len(self.snapshots))
                if self.checkpoint_dir is not None and self.checkpoint_every \
                        and self.step % self.checkpoint_every == 0:
                    self.save_checkpoint()
                self.dispatches += 1
                # one trace per dispatched step: phase spans the step
                # function opens at trace time (overlap psum buckets,
                # 1F1B microbatch ticks, ZeRO reduce/gather, ddp/sync)
                # join this context, so the compiling call's timeline
                # is a causal tree under train/step. Telemetry off:
                # trace_context yields None, span records nothing —
                # the compiled program never sees any of this.
                with trace_context(registry=self._reg()), \
                        span("train/step", registry=self._reg(),
                             step=self.step):
                    new_state = self._step_fn(self.state, self.step)
            except (KeyboardInterrupt, LedgerError,
                    RecoveryExhaustedError):
                raise
            except Exception as e:  # noqa: BLE001 — the classify point
                self._recover(e)
                continue
            self.state = new_state
            self.ledger.record_apply(self.step)
            self.step += 1
            reg = self._reg()
            if reg.enabled and self.dispatches:
                # keep the goodput ratio live (not just end-of-run) so
                # the monitor's goodput-drop rule sees it in-window
                reg.gauge("recovery/goodput_step_ratio").set(
                    (self.step - self.ledger.start_step)
                    / self.dispatches)
        report = self._report(exit_reason)
        reg = self._reg()
        if reg.enabled:
            reg.gauge("recovery/mttr_steps").set(report["mttr_steps"])
            reg.gauge("recovery/goodput_step_ratio").set(
                report["goodput_step_ratio"])
        self._event("run_done", **{k: report[k] for k in (
            "exit", "final_step", "restarts", "snapshot_restores",
            "checkpoint_restores", "mesh_shrinks", "steps_lost",
            "mttr_steps", "goodput_step_ratio")})
        return report

    def _report(self, exit_reason):
        recoveries = max(self.restarts, 1)
        applied = self.step - self.ledger.start_step
        return {
            "exit": exit_reason,
            "final_step": self.step,
            "world": self.world,
            "restarts": self.restarts,
            "causes": dict(self.causes),
            "snapshot_restores": self.snapshot_restores,
            "checkpoint_restores": self.checkpoint_restores,
            "mesh_shrinks": self.mesh_shrinks,
            "steps_lost": self.steps_lost,
            "mttr_steps": (self.steps_lost / recoveries
                           if self.restarts else 0.0),
            "dispatches": self.dispatches,
            "goodput_step_ratio": (applied / self.dispatches
                                   if self.dispatches else 1.0),
            "ledger": self.ledger.verify(expect_next=self.step),
        }

    # -- recovery -------------------------------------------------------

    def _recover(self, exc: BaseException) -> None:
        cls = classify_failure(exc)
        self.causes[cls] = self.causes.get(cls, 0) + 1
        policy = self.policies.get(cls) or \
            self.policies[FailureClass.UNKNOWN]
        self._count("recovery/restarts")
        self._count(f"recovery/cause/{cls}")
        reg = self._reg()
        if reg.enabled:
            # live-monitor feed: 1 from failure until the recovery
            # lands (a gave_up raise leaves it raised — correctly: the
            # run is down). telemetry.monitor escalates the failure
            # event to an alert and resolves it off this gauge.
            reg.gauge("recovery/in_recovery").set(1)
        self._event("failure", cls=cls, step=self.step,
                    action=policy.action,
                    error=f"{type(exc).__name__}: {str(exc)[:300]}")
        self.restarts += 1
        self.restarts_by_class[cls] = attempt = \
            self.restarts_by_class.get(cls, 0) + 1
        if policy.action == "reraise":
            self._event("gave_up", cls=cls, step=self.step,
                        reason="policy_reraise")
            raise exc
        if attempt > policy.max_restarts \
                or self.restarts > self.max_restarts_total:
            self._event("gave_up", cls=cls, step=self.step,
                        reason="budget_exhausted", attempts=attempt,
                        total=self.restarts)
            raise RecoveryExhaustedError(
                f"{cls} failure at step {self.step} exhausted the "
                f"restart budget (class attempt {attempt}/"
                f"{policy.max_restarts}, total {self.restarts}/"
                f"{self.max_restarts_total})") from exc
        wait = policy.backoff(attempt)
        if wait > 0:
            self._sleep(wait)
        action = policy.action
        if action == "snapshot_restore" and self.snapshots.latest() is None:
            # nothing hot yet: degrade to the durable tier if it exists
            action = ("checkpoint_restore" if self.checkpoint_dir
                      else "snapshot_restore")
        if action == "snapshot_restore":
            snap = self.snapshots.latest()
            if snap is None:
                self._event("gave_up", cls=cls, step=self.step,
                            reason="no_restore_tier")
                raise RecoveryExhaustedError(
                    f"{cls} failure at step {self.step} but no hot "
                    "snapshot and no checkpoint_dir to restore from"
                ) from exc
            state = HotSnapshots.copy_state(snap)
            if policy.adjust is not None:
                state = policy.adjust(state, exc)
            lost = self.ledger.record_rollback(snap.step, cause=cls)
            self.state = state
            self.step = snap.step
            self.steps_lost += lost
            self.snapshot_restores += 1
            self._count("recovery/snapshot_restores")
            self._count("recovery/steps_lost", lost)
            self._event("recovered", cls=cls, action="snapshot_restore",
                        resume_step=snap.step, steps_lost=lost,
                        attempt=attempt)
        elif action == "checkpoint_restore":
            try:
                meta = self.restore_from_checkpoint()
            except Exception as restore_exc:
                self._event("gave_up", cls=cls, step=self.step,
                            reason="restore_failed",
                            error=str(restore_exc)[:300])
                raise RecoveryExhaustedError(
                    f"{cls} failure at step {self.step} and the "
                    f"checkpoint restore failed too "
                    f"({type(restore_exc).__name__}: {restore_exc})"
                ) from exc
            if policy.adjust is not None:
                self.state = policy.adjust(self.state, exc)
            self.checkpoint_restores += 1
            self._count("recovery/checkpoint_restores")
            self._count("recovery/steps_lost",
                        getattr(self, "_last_restore_lost", 0))
            self._event("recovered", cls=cls, action="checkpoint_restore",
                        resume_step=self.step,
                        steps_lost=getattr(self, "_last_restore_lost", 0),
                        settled_step=meta["settled_step"],
                        rejected_steps=[r["step"]
                                        for r in meta["rejected"]],
                        attempt=attempt)
        elif action == "mesh_shrink":
            if self.rebuild is None:
                self._event("gave_up", cls=cls, step=self.step,
                            reason="no_rebuild_hook")
                raise RecoveryExhaustedError(
                    f"{cls} failure at step {self.step} wants a "
                    "mesh-shrink restart but no rebuild hook was given"
                ) from exc
            snap = self.snapshots.latest()
            if snap is None:
                self._event("gave_up", cls=cls, step=self.step,
                            reason="no_snapshot_for_shrink")
                raise RecoveryExhaustedError(
                    f"{cls} failure at step {self.step} but no hot "
                    "snapshot to rebuild from") from exc
            new_world = _canon_world(
                getattr(exc, "shrink_to", None)
                or policy.shrink_to
                or _half_world(self.world))
            host_state = HotSnapshots.copy_state(snap)
            if policy.adjust is not None:
                host_state = policy.adjust(host_state, exc)
            self._step_fn, self.state = self.rebuild(
                new_world, host_state, snap.step)
            lost = self.ledger.record_rollback(snap.step, cause=cls)
            self.step = snap.step
            self.steps_lost += lost
            self.world = new_world
            if self.topology is not None:
                self.topology = dict(self.topology,
                                     world=_world_json(new_world))
            self.snapshots.clear()  # old-world layouts must not restore
            self.mesh_shrinks += 1
            self._count("recovery/mesh_shrinks")
            self._count("recovery/steps_lost", lost)
            reg = self._reg()
            if reg.enabled:
                reg.gauge("recovery/world").set(_world_size(new_world))
            self._event("recovered", cls=cls, action="mesh_shrink",
                        resume_step=snap.step, steps_lost=lost,
                        world=_world_json(new_world), attempt=attempt)
        reg = self._reg()
        if reg.enabled:
            reg.gauge("recovery/in_recovery").set(0)
