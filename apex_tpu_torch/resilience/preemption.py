"""Preemption handling: turn SIGTERM into one final verified checkpoint.

Counterpart of ``apex_tpu/resilience/preemption.py`` (pure Python; the
port keeps its own copy). Clusters preempt a job with a SIGTERM and a
grace window; a training
loop that ignores it loses everything since the last periodic
checkpoint. :class:`PreemptionGuard` installs SIGTERM/SIGINT handlers
for the duration of a ``with`` block, flips a flag the loop can poll
between steps (``should_checkpoint()``), and — when the block exits
with the flag up and nothing saved yet — runs one final *synchronous*
``save_training_state`` so the state lands inside the grace window.
Prior handlers are restored on exit, whatever happens inside.

Two usage shapes::

    # polled: the loop decides where a step boundary is
    with PreemptionGuard() as guard:
        for step in range(n):
            state = train_step(state)
            if guard.should_checkpoint():
                checkpoint.save_training_state(d, step, **state)
                guard.mark_saved()
                break

    # callback: the guard itself runs the last save on exit
    with PreemptionGuard(final_save=lambda: checkpoint.save_training_state(
            d, current_step(), **snapshot())):
        train()

Signal handlers are a main-thread-only facility in CPython; off the
main thread the guard degrades to poll-only mode (``trigger()`` still
works — the fault injector uses it) with a warning rather than
refusing to run.
"""

import signal
import threading
import warnings
from typing import Callable, Optional

from apex_tpu_torch.telemetry.registry import get_registry


class PreemptionGuard:
    """Context manager bridging SIGTERM/SIGINT to a pollable
    checkpoint-now flag (see module docstring)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), *,
                 final_save: Optional[Callable[[], object]] = None):
        self._signals = tuple(signals)
        self._final_save = final_save
        self._prev_handlers = {}
        self._event = threading.Event()
        self._received = None
        self._saved = False
        self._installed = False
        self._counted = False

    # -- signal plumbing ----------------------------------------------------

    def _handler(self, signum, frame):
        # async-signal context: just record; telemetry/saving happen on
        # the training thread at the next poll / on exit
        self._received = signum
        self._event.set()

    def __enter__(self):
        try:
            for sig in self._signals:
                self._prev_handlers[sig] = signal.signal(sig, self._handler)
            self._installed = True
        except ValueError:  # not the main thread
            self._prev_handlers.clear()
            warnings.warn(
                "PreemptionGuard: cannot install signal handlers off the "
                "main thread; running in poll-only mode (trigger() still "
                "flips the flag)")
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if (exc_type is None and self.preempted and not self._saved
                    and self._final_save is not None):
                self.save_now()
        finally:
            if self._installed:
                for sig, prev in self._prev_handlers.items():
                    signal.signal(sig, prev)
                self._prev_handlers.clear()
                self._installed = False
        return False

    # -- the loop-facing surface --------------------------------------------

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self):
        """The signal that triggered, or None."""
        return self._received

    def trigger(self, signum=signal.SIGTERM):
        """Flip the flag programmatically (fault injection / tests /
        cluster agents that learn of preemption out-of-band)."""
        self._handler(signum, None)

    def should_checkpoint(self) -> bool:
        """True once preempted and the final checkpoint has not been
        written yet — the per-step poll."""
        if not self._event.is_set():
            return False
        if not self._counted:  # first poll after the signal: record it
            self._counted = True
            reg = get_registry()
            if reg.enabled:
                reg.counter("preemption/signals").inc()
                reg.event("preemption", "signal", signum=self._received)
        return not self._saved

    def mark_saved(self):
        """Tell the guard the final checkpoint landed (suppresses the
        exit-time ``final_save``)."""
        self._saved = True
        self._record("saved")

    def save_now(self):
        """Run the ``final_save`` callable synchronously, once."""
        if self._final_save is None:
            raise ValueError("PreemptionGuard: no final_save callable given")
        if self._saved:
            return
        self._record("final_save")
        self._final_save()
        self._saved = True

    def wait(self, timeout=None) -> bool:
        """Block until preempted (tests, watcher threads)."""
        return self._event.wait(timeout)

    def _record(self, what):
        reg = get_registry()
        if reg.enabled:
            reg.event("preemption", what, signum=self._received)
