"""Process-wide metrics registry with a JSONL event sink.

Counterpart of ``apex_tpu/telemetry/registry.py``, with the same names,
events and JSONL schema, so ``tools/telemetry_report.py`` and
``tools/trace_export.py`` read this package's sink as they read the JAX
package's. Counters (monotonic), gauges (last value), and histograms
(count/total/min/max/last), plus a structured event stream written as
JSON Lines under ``$APEX_TPU_TELEMETRY_DIR``. Everything is
**host-side**: recording happens in Python and reads nothing from the
card unless a caller hands it a host number. Kept apart from the launch
counters of :mod:`apex_tpu_torch.kernels.registry`.

Disabled is the default and costs nothing: ``get_registry()`` resolves
to a registry whose ``enabled`` flag is False unless
``APEX_TPU_TELEMETRY_DIR`` is set (or ``enable()`` is called
programmatically, to collect in-memory comm accounting even when no
sink directory is configured), and every
``counter()/gauge()/histogram()`` call on a disabled registry returns a
shared no-op instrument.

Rank discipline: on multi-process runs each process writes its own
``telemetry-rank<N>.jsonl``; ``APEX_TPU_TELEMETRY_RANK0_ONLY=1``
restricts both the sink and the ``log_summary`` logging path to rank 0
(the rank in the default ``torch.distributed`` group, 0 without one).

Clock discipline: every event carries two stamps — ``t`` (wall clock,
human-facing, NTP-skewable) and ``ts`` (seconds on one monotonic
``perf_counter`` epoch per registry). A ``trace_epoch`` header record
written at sink open carries ``epoch_unix`` (the wall-clock value of
``ts == 0``), so ``tools/trace_export.py`` can place every rank's
monotonic timeline on one absolute axis without trusting per-event
wall clocks to agree across processes.
"""

import collections
import json
import os
import threading
import time

ENV_DIR = "APEX_TPU_TELEMETRY_DIR"
ENV_RANK0_ONLY = "APEX_TPU_TELEMETRY_RANK0_ONLY"


def _process_index():
    """This process's rank in the default ``torch.distributed`` group
    where one is up, else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


class Counter:
    """Monotonic float counter. ``inc`` only; use a Gauge for levels."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        with self._lock:
            self.value += float(amount)

    def read(self):
        """Locked read — pairs with :meth:`inc` so a snapshot never
        observes a torn update."""
        with self._lock:
            return self.value


class Gauge:
    """Last-value-wins instrument."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = None

    def set(self, value):
        self.value = float(value)


class Histogram:
    """Streaming summary (count/total/min/max/last) plus a bounded
    sample reservoir for tail percentiles.

    The reservoir keeps the most recent ``RESERVOIR`` observations (a
    sliding window, not a statistical sample — serving latency wants
    the RECENT tail, and p99-of-the-last-4096 answers "how is the
    system doing now"); :meth:`percentile` and the ``p50``/``p99``
    summary fields read it. Older aggregate fields are exact over the
    full stream."""

    RESERVOIR = 4096

    __slots__ = ("name", "count", "total", "min", "max", "last",
                 "_samples", "_lock")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.last = None
        self._samples = collections.deque(maxlen=self.RESERVOIR)
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self.last = value
            self._samples.append(value)

    @staticmethod
    def _interp(samples, q):
        if not samples:
            return None
        if len(samples) == 1:
            return samples[0]
        pos = (len(samples) - 1) * (float(q) / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(samples) - 1)
        return samples[lo] + (samples[hi] - samples[lo]) * (pos - lo)

    def percentile(self, q):
        """Linear-interpolated percentile (``q`` in [0, 100]) over the
        reservoir window; None before the first observation."""
        with self._lock:
            samples = sorted(self._samples)
        return self._interp(samples, q)

    def summary(self):
        """Consistent summary: every field — aggregates AND the
        percentile pair — is read under ONE lock acquisition, so
        ``count`` always agrees with the reservoir it was taken with
        (the torn read the old piecemeal version allowed)."""
        with self._lock:
            count, total = self.count, self.total
            mn, mx, last = self.min, self.max, self.last
            samples = sorted(self._samples)
        return {
            "count": count,
            "total": total,
            "mean": (total / count) if count else None,
            "min": mn,
            "max": mx,
            "last": last,
            "p50": self._interp(samples, 50),
            "p99": self._interp(samples, 99),
        }


class _Null:
    """Shared no-op instrument handed out by a disabled registry — the
    zero-overhead-off contract: call sites never branch on enablement."""

    __slots__ = ()
    value = 0.0
    count = 0

    def inc(self, amount=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    def percentile(self, q):
        return None


_NULL = _Null()


class MetricsRegistry:
    """Counters + gauges + histograms + a JSONL event sink.

    ``enabled`` gates *everything*; a disabled registry returns no-op
    instruments and drops events, so library code records
    unconditionally and pays nothing by default.
    """

    def __init__(self, *, enabled=False, jsonl_dir=None, rank0_only=None):
        self._lock = threading.RLock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}
        self._enabled = bool(enabled) or jsonl_dir is not None
        self._jsonl_dir = jsonl_dir
        self._sink = None
        self._rank0_only = (os.environ.get(ENV_RANK0_ONLY) == "1"
                            if rank0_only is None else bool(rank0_only))
        # In-process event taps (the live monitor's intake). A tuple so
        # event() can iterate a consistent view without holding the
        # lock; mutation replaces the tuple under the lock.
        self._taps = ()
        # Sampled back-to-back so epoch_unix ~= the wall clock at ts=0;
        # residual skew is one statement, not an NTP step.
        self._perf_origin = time.perf_counter()
        self._epoch_unix = time.time()

    # -- clock --------------------------------------------------------------

    def now(self):
        """Seconds since this registry's ``perf_counter`` epoch — the
        monotonic clock every event ``ts`` shares."""
        return time.perf_counter() - self._perf_origin

    def to_ts(self, perf_t):
        """Convert a raw ``time.perf_counter()`` reading (e.g. a span
        start captured before the event is emitted) onto the ``ts``
        clock."""
        return perf_t - self._perf_origin

    # -- enablement ---------------------------------------------------------

    @property
    def enabled(self):
        return self._enabled

    @property
    def jsonl_dir(self):
        return self._jsonl_dir

    def enable(self, jsonl_dir=None):
        """Turn collection on; idempotent. ``jsonl_dir`` (may be None
        for in-memory-only collection) attaches/retargets the event
        sink."""
        with self._lock:
            self._enabled = True
            if jsonl_dir and jsonl_dir != self._jsonl_dir:
                self._close_sink_locked()
                self._jsonl_dir = jsonl_dir
        return self

    def disable(self):
        with self._lock:
            self._enabled = False
            self._close_sink_locked()
        return self

    # -- instruments --------------------------------------------------------

    def counter(self, name):
        if not self._enabled:
            return _NULL
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name):
        if not self._enabled:
            return _NULL
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name):
        if not self._enabled:
            return _NULL
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def counter_value(self, name):
        """Current value of a counter (0.0 when absent/disabled) —
        the delta-measurement hook."""
        with self._lock:
            c = self._counters.get(name)
            return c.value if c is not None else 0.0

    # -- events -------------------------------------------------------------

    def add_event_tap(self, fn):
        """Register an in-process event consumer: ``fn(record)`` is
        called synchronously for every event an *enabled* registry
        emits, before (and regardless of) the JSONL write — the live
        monitor's intake. Taps see events even when no sink dir is
        configured and are NOT gated by rank0-only mode (that gates the
        on-disk/logging paths; a tap is this process watching itself).
        Taps must treat the record as read-only. Returns ``fn``."""
        with self._lock:
            if fn not in self._taps:
                self._taps = self._taps + (fn,)
        return fn

    def remove_event_tap(self, fn):
        with self._lock:
            self._taps = tuple(t for t in self._taps if t is not fn)

    def event(self, kind, name, **fields):
        """Dispatch one structured event: to every registered tap, and
        appended to the JSONL sink (when a sink dir is configured and
        this rank may write). No-op — and no record is even built —
        unless enabled and at least one consumer exists."""
        if not self._enabled:
            return
        taps = self._taps
        sink_ok = (self._jsonl_dir is not None
                   and not (self._rank0_only and _process_index() != 0))
        if not taps and not sink_ok:
            return
        rec = {"t": round(time.time(), 6), "ts": round(self.now(), 9),
               "kind": kind, "name": name}
        rec.update(fields)  # an explicit ts= overrides the stamp
        for tap in taps:
            try:
                tap(rec)
            except Exception:
                pass  # a broken monitor must never take down training
        if not sink_ok:
            return
        line = json.dumps(rec, default=str)
        with self._lock:
            sink = self._open_sink_locked()
            if sink is not None:
                sink.write(line + "\n")
                sink.flush()

    def _open_sink_locked(self):
        if self._sink is None and self._jsonl_dir is not None:
            try:
                os.makedirs(self._jsonl_dir, exist_ok=True)
                path = os.path.join(
                    self._jsonl_dir,
                    f"telemetry-rank{_process_index()}.jsonl")
                self._sink = open(path, "a")
                # Clock-alignment header: epoch_unix is the wall clock
                # at ts=0 for everything this registry writes below it.
                header = {
                    "t": round(time.time(), 6),
                    "ts": round(self.now(), 9),
                    "kind": "trace_epoch", "name": "epoch",
                    "epoch_unix": round(time.time() - self.now(), 6),
                    "pid": os.getpid(),
                    "rank": _process_index(),
                }
                self._sink.write(json.dumps(header) + "\n")
                self._sink.flush()
            except OSError:
                # an unwritable sink dir must never take down training
                self._jsonl_dir = None
                self._sink = None
        return self._sink

    def _close_sink_locked(self):
        if self._sink is not None:
            try:
                self._sink.close()
            finally:
                self._sink = None

    # -- snapshots ----------------------------------------------------------

    def snapshot(self):
        """Atomic plain-dict view of every instrument
        (JSON-serializable) — the monitor's read primitive.

        Consistency contract: the instrument *set* is frozen under the
        registry lock (no instrument appears or vanishes mid-walk), and
        each instrument is then read through its own locked read path
        (``Counter.read``, ``Histogram.summary`` — one lock acquisition
        per instrument, so no summary is ever internally torn between
        its aggregate fields and its percentile reservoir). ``ts`` is
        the registry-monotonic stamp of the snapshot itself, so two
        snapshots bound a well-defined rate window."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            histograms = list(self._histograms.items())
            ts = self.now()
        return {
            "ts": round(ts, 9),
            "counters": {k: c.read() for k, c in counters},
            "gauges": {k: g.value for k, g in gauges},
            "histograms": {k: h.summary() for k, h in histograms},
        }

    def flush(self):
        """Write one ``kind="summary"`` event carrying the full
        snapshot — the record tools/telemetry_report.py aggregates."""
        self.event("summary", "registry", **self.snapshot())

    def reset(self):
        """Drop all instruments (tests / per-phase accounting)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def log_summary(self, logger=None, level=None):
        """Emit a one-line snapshot through ``logging`` (the logger
        ``apex_tpu_torch.telemetry`` by default). Honors rank0-only
        mode."""
        import logging

        if not self._enabled:
            return
        if self._rank0_only and _process_index() != 0:
            return
        logger = logger or logging.getLogger("apex_tpu_torch.telemetry")
        logger.log(level or logging.INFO,
                   "telemetry %s", json.dumps(self.snapshot()))


_REGISTRY = None
_REGISTRY_LOCK = threading.Lock()


def get_registry():
    """The process-wide registry, created on first use. Enabled (with
    the JSONL sink attached) iff ``APEX_TPU_TELEMETRY_DIR`` was set when
    first resolved; call ``get_registry().enable(...)`` to opt in
    programmatically afterwards."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry(
                    jsonl_dir=os.environ.get(ENV_DIR) or None)
    return _REGISTRY


def set_registry(registry):
    """Swap the process-wide registry (tests); returns the previous one."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        prev, _REGISTRY = _REGISTRY, registry
    return prev


class use_registry:
    """Context manager installing ``registry`` as process-wide for the
    block — the test idiom for isolated measurement::

        with use_registry(MetricsRegistry(enabled=True)) as reg:
            ...
            assert reg.counter_value("comm/bytes") > 0
    """

    def __init__(self, registry):
        self.registry = registry
        self._prev = None

    def __enter__(self):
        self._prev = set_registry(self.registry)
        return self.registry

    def __exit__(self, *exc):
        set_registry(self._prev)
        return False
