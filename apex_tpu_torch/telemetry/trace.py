"""Named spans with causal identity, device fencing and profiler hooks.

Counterpart of ``apex_tpu/telemetry/trace.py``: the same span events,
ids and ``TraceContext``, so ``tools/trace_export.py`` turns this
package's sink into a Chrome/Perfetto trace as it does the JAX
package's. A span measures host wall-clock (``time.perf_counter``)
between ``start()`` and ``stop()``; with ``sync=True`` it fences the
card on both edges (``torch.cuda.synchronize()``) so the interval covers
the device work queued inside it. While open, a span nests under
``torch.profiler.record_function``, so spans show up by name in a
``torch.profiler`` trace.

Causal identity: every span opened while the registry is enabled mints
a ``span_id`` and joins the ambient :class:`TraceContext` (a
contextvar), so nested spans form a tree under one ``trace_id``. A span
emits a ``span_begin`` event at open and a ``span`` event at close,
both carrying ``trace_id``/``span_id``/``parent_id``. Host loops that
multiplex many logical requests (the serving scheduler) stamp identities
explicitly via :func:`emit_span` / :func:`emit_flow`.

CUDA graphs: nothing records inside a graph body. A fenced span opened
while the current stream is capturing raises (a synchronize would break
the capture); record around the replay instead. A disabled registry
mints no ids and never touches the contextvar.

``start_profiler_trace()``/``stop_profiler_trace()`` bracket a
``torch.profiler`` trace, gated by ``APEX_TPU_PROFILE_DIR`` so entry
points can call them unconditionally.
"""

import contextlib
import contextvars
import dataclasses
import os
import time

from apex_tpu_torch.telemetry.registry import get_registry

ENV_PROFILE_DIR = "APEX_TPU_PROFILE_DIR"


# -- causal identity --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Immutable causal identity: which trace this code runs under and
    which span is the current parent. ``baggage`` is a tuple of
    ``(key, value)`` pairs (kept a tuple so the dataclass stays frozen
    and cheap) propagated to children — request tier, replica label,
    anything a downstream span should inherit without plumbing."""

    trace_id: str
    span_id: str = ""
    parent_id: str = ""
    baggage: tuple = ()

    def bag(self):
        return dict(self.baggage)

    def to_wire(self):
        """JSON-serializable form for cross-process payloads (the
        fleet's KV-state migration carries this so donor + survivor
        spans stitch into one trace)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id,
                "baggage": [list(kv) for kv in self.baggage]}

    @classmethod
    def from_wire(cls, wire):
        return cls(trace_id=wire["trace_id"],
                   span_id=wire.get("span_id", ""),
                   parent_id=wire.get("parent_id", ""),
                   baggage=tuple((k, v) for k, v
                                 in wire.get("baggage", ())))


_CURRENT = contextvars.ContextVar("apex_tpu_trace_context", default=None)


def current_trace():
    """The ambient :class:`TraceContext`, or None outside any trace."""
    return _CURRENT.get()


def new_trace_id():
    return os.urandom(8).hex()


def new_span_id():
    return os.urandom(4).hex()


@contextlib.contextmanager
def trace_context(trace_id=None, *, baggage=None, registry=None):
    """Establish (or join) a trace for the dynamic extent of the block;
    spans opened inside parent under it. ``trace_id=None`` inherits the
    ambient trace or mints a fresh id at a root. Yields the installed
    context — or None with the contextvar untouched when telemetry is
    disabled (no ids are minted: the zero-overhead-off contract)."""
    reg = registry or get_registry()
    if not reg.enabled:
        yield None
        return
    parent = _CURRENT.get()
    if trace_id is None:
        trace_id = parent.trace_id if parent is not None else new_trace_id()
    merged = dict(parent.baggage) if parent is not None else {}
    if baggage:
        merged.update(baggage)
    ctx = TraceContext(
        trace_id=trace_id,
        span_id=parent.span_id if parent is not None else "",
        parent_id=parent.parent_id if parent is not None else "",
        baggage=tuple(sorted(merged.items())))
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def emit_span(name, start, end=None, *, registry=None, trace_id=None,
              span_id=None, parent_id=None, **attrs):
    """Record an externally-timed span. ``start``/``end`` are raw
    ``time.perf_counter()`` readings (``end=None`` means now); the
    event's ``ts`` is the span END on the registry's epoch clock, so
    exporters recover the start as ``ts - duration_s``. Returns the
    span_id so callers can parent follow-up phases — None when
    telemetry is off, and nothing is recorded."""
    reg = registry or get_registry()
    if not reg.enabled:
        return None
    end = time.perf_counter() if end is None else end
    elapsed = end - start
    sid = span_id or new_span_id()
    reg.histogram(f"span/{name}").observe(elapsed)
    reg.event("span", name, duration_s=round(elapsed, 9),
              ts=round(reg.to_ts(end), 9), trace_id=trace_id,
              span_id=sid, parent_id=parent_id or "", **attrs)
    return sid


def emit_flow(name, flow_id, phase, *, registry=None, trace_id=None,
              **attrs):
    """Record one end of a cross-context arrow: ``phase="out"`` at the
    producer, ``"in"`` at the consumer. ``tools/trace_export.py`` pairs
    out/in records sharing ``flow_id`` into Chrome flow events (the
    arrows across process rows at a migration handoff)."""
    reg = registry or get_registry()
    if not reg.enabled:
        return
    reg.event("trace_flow", name, flow_id=flow_id, phase=phase,
              trace_id=trace_id, **attrs)


def _capturing():
    try:
        import torch

        return (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())
    except Exception:
        return False


def device_sync():
    """Fence the card's outstanding work (``torch.cuda.synchronize()``;
    nothing without CUDA). Raises inside a CUDA-graph capture: a fence
    there would break the capture."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a fenced span inside a CUDA-graph capture: nothing records "
            "inside a graph body; record around the replay")
    torch.cuda.synchronize()


def _annotations(name):
    """``torch.profiler.record_function`` for the span's extent (none
    inside a CUDA-graph capture: the range would be recorded once, at
    capture)."""
    stack = contextlib.ExitStack()
    if _capturing():
        return stack
    try:
        from torch.profiler import record_function

        stack.enter_context(record_function(name))
    except Exception:
        pass
    return stack


class Span:
    """Restartable named timer; also usable as a context manager.

    ``sync=True`` fences the device on both edges. Timing always works,
    even with telemetry off; metric
    recording — a ``span/<name>`` histogram in seconds, a
    ``span_begin`` event at open, and a ``span`` event at close, the
    events carrying ``trace_id``/``span_id``/``parent_id`` from the
    ambient :class:`TraceContext` — happens only when the registry is
    enabled. While open (and enabled) the span installs itself as the
    current context, so nested spans parent under it.
    """

    __slots__ = ("name", "sync", "attrs", "start_time", "_stack",
                 "_registry", "trace_id", "span_id", "parent_id",
                 "_token")

    def __init__(self, name, *, sync=False, registry=None, **attrs):
        self.name = name
        self.sync = sync
        self.attrs = attrs
        self.start_time = None
        self._stack = None
        self._registry = registry
        self.trace_id = None
        self.span_id = None
        self.parent_id = None
        self._token = None

    def start(self):
        if self.sync:
            device_sync()
        reg = self._registry or get_registry()
        if reg.enabled:
            ctx = _CURRENT.get()
            self.trace_id = (ctx.trace_id if ctx is not None
                             else new_trace_id())
            self.parent_id = ctx.span_id if ctx is not None else ""
            self.span_id = new_span_id()
            self._token = _CURRENT.set(TraceContext(
                trace_id=self.trace_id, span_id=self.span_id,
                parent_id=self.parent_id,
                baggage=ctx.baggage if ctx is not None else ()))
            reg.event("span_begin", self.name, trace_id=self.trace_id,
                      span_id=self.span_id, parent_id=self.parent_id,
                      **self.attrs)
        self._stack = _annotations(self.name)
        self.start_time = time.perf_counter()
        return self

    def stop(self):
        """Close the span; returns the elapsed seconds."""
        if self.sync:
            device_sync()
        elapsed = time.perf_counter() - self.start_time
        if self._stack is not None:
            self._stack.close()
            self._stack = None
        if self._token is not None:
            # Reset can only happen from the context that set the
            # token; a span handed across threads keeps its identity
            # but cannot pop the foreign context.
            with contextlib.suppress(ValueError):
                _CURRENT.reset(self._token)
            self._token = None
        reg = self._registry or get_registry()
        if reg.enabled:
            reg.histogram(f"span/{self.name}").observe(elapsed)
            ids = {}
            if self.span_id is not None:
                ids = {"trace_id": self.trace_id,
                       "span_id": self.span_id,
                       "parent_id": self.parent_id}
            reg.event("span", self.name, duration_s=round(elapsed, 9),
                      **ids, **self.attrs)
        return elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def span(name, *, sync=False, registry=None, **attrs):
    """``with span("train/step"): ...`` — see :class:`Span`."""
    return Span(name, sync=sync, registry=registry, **attrs)


_PROFILER = None


def start_profiler_trace(logdir=None):
    """Start a ``torch.profiler`` trace (CPU and, where there is one, the
    card's activity) when ``APEX_TPU_PROFILE_DIR`` (or ``logdir``) names
    a directory; returns True iff a trace started. Safe to call
    unconditionally and when a trace is already running."""
    global _PROFILER
    logdir = logdir or os.environ.get(ENV_PROFILE_DIR)
    if not logdir or _PROFILER is not None:
        return False
    try:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
        prof.start()
    except Exception:
        return False
    _PROFILER = prof
    reg = get_registry()
    if reg.enabled:
        reg.event("profiler", "start", logdir=logdir)
    return True


def stop_profiler_trace():
    """Stop the trace started by :func:`start_profiler_trace` (its file
    lands under the directory); returns True iff one was stopped."""
    global _PROFILER
    if _PROFILER is None:
        return False
    prof, _PROFILER = _PROFILER, None
    try:
        prof.stop()
    except Exception:
        return False
    reg = get_registry()
    if reg.enabled:
        reg.event("profiler", "stop")
    return True
