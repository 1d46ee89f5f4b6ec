"""apex_tpu_torch.resilience — surviving the failures a long run will see.

Counterpart of ``apex_tpu/resilience/``, with its names:

- :mod:`supervisor` — the recovery loop: :class:`Supervisor` wraps a
  step function, classifies each failure (:func:`classify_failure`) and
  applies a per-class :class:`RecoveryPolicy` (hot-snapshot revert +
  loss-scale backoff for numerics and OOM, checkpoint fallback for
  corruption, one final save + clean exit for preemption, a mesh-shrink
  restart through the caller's ``rebuild`` hook for device loss), with a
  step-monotonic :class:`StepLedger`.
- :mod:`guard` — the non-finite step guard: :func:`guarded_update`
  skips a poisoned step on the card (K7's non-finite counts, one fp32
  all-reduce of the flag, the fused optimizers' device ``found_inf``,
  ``torch.where`` for the rest of the state; no host sync) and
  :func:`check_guard` escalates to :class:`NonFiniteError` after K
  consecutive skips, with the flight recorder's post-mortem.
- ``checkpoint`` — durability lives in :mod:`apex_tpu_torch.checkpoint`.
- :mod:`preemption` — :class:`PreemptionGuard` turns SIGTERM/SIGINT
  into a pollable checkpoint-now flag plus one final synchronous save.
- :mod:`faults` — deterministic, env/API-gated injectors.
"""

from apex_tpu_torch.resilience import faults  # noqa: F401
from apex_tpu_torch.resilience import preemption  # noqa: F401
from apex_tpu_torch.resilience import supervisor  # noqa: F401
from apex_tpu_torch.resilience.faults import DeviceLostError  # noqa: F401
from apex_tpu_torch.resilience.guard import (  # noqa: F401
    GuardState,
    NonFiniteError,
    check_guard,
    flag_from_stats,
    guarded_call,
    guarded_update,
    init_guard_state,
    nonfinite_flag,
)
from apex_tpu_torch.resilience.preemption import PreemptionGuard  # noqa: F401
from apex_tpu_torch.resilience.supervisor import (  # noqa: F401
    FailureClass,
    LedgerError,
    RecoveryExhaustedError,
    RecoveryPolicy,
    StepLedger,
    Supervisor,
    classify_failure,
    default_policies,
    loss_scale_backoff,
)
from apex_tpu_torch.telemetry.memory import HBMExhaustedError  # noqa: F401
