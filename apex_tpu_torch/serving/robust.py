"""Serving-path fault tolerance: admission policy, deadlines, retries.

A copy of ``apex_tpu/serving/robust.py`` (which imports no JAX), kept
in the port so that it imports nothing of ``apex_tpu``. All of it is
host-side policy:

- **Admission control & load shedding** (:class:`RobustConfig`
  ``max_pending`` / ``admission_policy``): the pending queue is
  bounded; past the bound either the newcomer is rejected
  (``reject_newest``) or the oldest queued request is shed to make
  room (``shed_oldest``).
- **Per-request deadlines** (``ttft_deadline_s`` /
  ``total_deadline_s``, overridable per
  :class:`~apex_tpu_torch.serving.scheduler.Request`): checked each
  scheduler tick; an expired request is evicted with the
  ``deadline_exceeded`` terminal status.
- **Per-slot NaN quarantine**: the engine's decode step derives a
  per-slot finite flag from the logits on the device and zeroes a
  poisoned slot's KV rows in the same step; the scheduler evicts the
  sequence with status ``poisoned`` while healthy slots keep decoding.
  Every slot non-finite at once escalates to :class:`NonFiniteError`.
- **Decode retry with capped exponential backoff**
  (:func:`retry_backoff_s`, :func:`is_retryable_decode_error`): a
  transient failure (a CUDA out-of-memory error, or a runtime error
  carrying a transient status) is retried up to ``decode_retries``
  times before :class:`DecodeFailedError` fails only the implicated
  requests.
- **Graceful drain**: ``Scheduler.drain()`` stops admissions, lets
  in-flight work finish up to ``drain_deadline_s``, and records a
  :class:`DrainReport`. (The JAX package's ``PreemptionGuard`` trigger
  comes with the resilience slice.)

Terminal statuses (``CompletedRequest.finish_reason``): ``length`` and
``eos`` are the goodput statuses (:data:`OK_STATUSES`); every other one
(``deadline_exceeded``, ``poisoned``, ``failed``, ``drained``,
``max_steps``) is a failure with its own count.
"""

import dataclasses
from typing import Optional

from apex_tpu_torch.resilience import guard as _guard

ADMISSION_POLICIES = ("reject_newest", "shed_oldest")

# finish_reason values that count toward goodput; every other terminal
# status is a failure mode with its own count
OK_STATUSES = ("length", "eos")
FAILURE_STATUSES = ("deadline_exceeded", "poisoned", "failed",
                    "drained", "max_steps")

# rejection reasons of requests that never reached a slot (distinct
# from the terminal statuses above)
REJECT_REASONS = ("queue_full", "shed", "prompt_too_long",
                  "budget_too_long", "duplicate_rid", "draining")


class DecodeFailedError(RuntimeError):
    """A decode dispatch kept failing past the retry budget. Carries
    ``attempts`` (total tries) and ``last_error``; the scheduler
    catches it and fails only the implicated requests."""

    def __init__(self, msg, *, attempts=0, last_error=None):
        super().__init__(msg)
        self.attempts = int(attempts)
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Serving fault-tolerance knobs — all host-side policy.

    ``None`` disables a deadline; ``max_pending=None`` leaves the
    queue unbounded. Defaults are deliberately permissive: failures
    carry terminal statuses instead of raising out of ``run``.
    """

    max_pending: Optional[int] = None
    admission_policy: str = "reject_newest"
    ttft_deadline_s: Optional[float] = None
    total_deadline_s: Optional[float] = None
    decode_retries: int = 2
    retry_backoff_s: float = 0.05
    retry_backoff_cap_s: float = 1.0
    drain_deadline_s: float = 30.0
    quarantine: bool = True
    health_every: int = 0          # ticks between health events; 0 = end only

    def __post_init__(self):
        if self.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission_policy {self.admission_policy!r} not in "
                f"{ADMISSION_POLICIES}")
        if self.max_pending is not None and self.max_pending < 0:
            raise ValueError(
                f"max_pending ({self.max_pending}) must be >= 0 or None")
        if self.decode_retries < 0:
            raise ValueError(
                f"decode_retries ({self.decode_retries}) must be >= 0")
        for name in ("ttft_deadline_s", "total_deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} ({v}) must be > 0 or None")
        if self.retry_backoff_s < 0 or self.retry_backoff_cap_s < 0:
            raise ValueError("retry backoff must be >= 0")
        if self.drain_deadline_s < 0:
            raise ValueError(
                f"drain_deadline_s ({self.drain_deadline_s}) must be >= 0")


def retry_backoff_s(attempt, base_s, cap_s):
    """Capped exponential backoff before retry ``attempt`` (0-based):
    ``min(base * 2**attempt, cap)``. The cap keeps a retry burst from
    blowing a request's total-latency deadline on its own."""
    return min(float(base_s) * (2.0 ** int(attempt)), float(cap_s))


# markers in a runtime error message that make a decode dispatch worth
# retrying: transient runtime statuses, as the JAX package lists them
_RETRYABLE_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "ABORTED",
                      "DEADLINE_EXCEEDED", "INTERNAL")


def is_retryable_decode_error(exc) -> bool:
    """Whether a decode dispatch failure is worth re-dispatching: a CUDA
    out-of-memory error (a fragmented allocator often succeeds once
    transient buffers are freed) or a runtime error carrying a transient
    status marker. Anything else (a shape error, a bug) fails fast."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _RETRYABLE_MARKERS)


# every slot of a decode batch non-finite at once (poisoned weights or
# activations, not one poisoned request) escalates to the resilience
# guard's error, as in the JAX package
NonFiniteError = _guard.NonFiniteError


@dataclasses.dataclass
class RejectedRequest:
    """A request that never reached a slot: shed at admission, bounced
    for an impossible shape, or refused during drain. Lands in
    ``Scheduler.rejected`` with the reason."""

    rid: int
    reason: str                    # one of REJECT_REASONS
    tick: float
    prompt_len: int = 0
    detail: str = ""


@dataclasses.dataclass
class DrainReport:
    """What a graceful drain accomplished inside its deadline, kept on
    the scheduler as ``drain_report`` (an operator reads it to decide
    whether the grace window is long enough)."""

    reason: str                    # "requested"
    started_tick: float
    drain_s: float
    completed_in_drain: int        # in-flight requests that finished
    cancelled_active: int          # evicted at the deadline, status "drained"
    cancelled_pending: int         # never admitted, status "drained"
    deadline_hit: bool

    def as_event_fields(self):
        return dataclasses.asdict(self)


class ServeHealth:
    """Rolling backpressure / failure accounting for one scheduler.

    One instance per :class:`~apex_tpu_torch.serving.scheduler.Scheduler`;
    the scheduler increments the fields as requests move through
    terminal states, and ``Scheduler.stats()`` reports shed rate and
    goodput from them."""

    __slots__ = ("submitted", "rejected", "expired", "quarantined",
                 "failed", "drained", "max_steps", "decode_retries",
                 "decode_failures", "all_slots_nonfinite")

    def __init__(self):
        self.submitted = 0
        self.rejected = 0
        self.expired = 0
        self.quarantined = 0
        self.failed = 0
        self.drained = 0
        self.max_steps = 0
        self.decode_retries = 0
        self.decode_failures = 0
        self.all_slots_nonfinite = 0

    def shed_rate(self):
        """Fraction of submitted requests rejected at admission."""
        return (self.rejected / self.submitted) if self.submitted else 0.0

    def snapshot(self):
        return {name: getattr(self, name) for name in self.__slots__}

    def emit(self, registry, *, tick, pending, active, free,
             completed_ok, draining):
        """Land the health snapshot: gauge + one structured event."""
        if not registry.enabled:
            return
        registry.gauge("serve/pending_depth").set(pending)
        registry.event(
            "serve", "health", tick=tick, pending=pending, active=active,
            free=free, completed_ok=completed_ok, draining=draining,
            shed_rate=round(self.shed_rate(), 4), **self.snapshot())
