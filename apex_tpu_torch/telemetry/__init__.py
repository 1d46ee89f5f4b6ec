"""apex_tpu_torch.telemetry — tracing, metrics, numerics and memory
accounting for the port.

Counterpart of ``apex_tpu/telemetry/``, with its module names, public
names, event and metric names and JSONL schema, so the JAX package's
readers (``tools/telemetry_report.py``, ``tools/trace_export.py``,
``tools/numerics_report.py``, ``tools/memory_report.py``) render this
package's sink unchanged:

- :mod:`registry`  — process-wide counters/gauges/histograms + a JSONL
  event sink under ``$APEX_TPU_TELEMETRY_DIR`` (rank-aware).
- :mod:`trace`     — named :func:`span` context managers (optional
  ``torch.cuda.synchronize`` fencing, nested under
  ``torch.profiler.record_function``), :class:`TraceContext` on a
  contextvar, and ``start_profiler_trace``/``stop`` around a
  ``torch.profiler`` trace, gated by ``APEX_TPU_PROFILE_DIR``.
- :mod:`comm`      — measured collective accounting.
- :mod:`numerics`  — per-tensor and per-module-prefix statistics on the
  card, from K7 (``kernels/stats.py``).
- :mod:`recorder`  — :class:`FlightRecorder`, a device ring of the last
  K steps' statistics, and its ``numerics-postmortem-rank<N>.json``.
- :mod:`memory`    — measured step peaks, the live-storage census, the
  preflight and the ``memory-postmortem-rank<N>.json`` OOM handler.
- :mod:`cost`      — FLOPs of a step (``FlopCounterMode`` plus the
  port's kernels' own counts) and MFU against the card's peaks.
- :mod:`compile_watch` — signature-keyed compile accounting, CUDA-graph
  captures and ``nvcc`` builds, and :func:`assert_no_recompiles`.

Not ported yet: ``monitor`` (the live monitor, with the fleet, ROADMAP
queue A item 5(c)) and ``attribution`` (with pipeline parallelism, item
6); their names raise ``NotImplementedError`` naming the item.

Disabled — the default, when ``APEX_TPU_TELEMETRY_DIR`` is unset and
nothing called ``enable()`` — every instrument is a shared no-op and
nothing reads the card.
"""

from apex_tpu_torch.telemetry.registry import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    set_registry,
    use_registry,
)
from apex_tpu_torch.telemetry.trace import (  # noqa: F401
    Span,
    TraceContext,
    current_trace,
    device_sync,
    emit_flow,
    emit_span,
    new_span_id,
    new_trace_id,
    span,
    start_profiler_trace,
    stop_profiler_trace,
    trace_context,
)
from apex_tpu_torch.telemetry import comm  # noqa: F401
from apex_tpu_torch.telemetry import compile_watch  # noqa: F401
from apex_tpu_torch.telemetry import cost  # noqa: F401
from apex_tpu_torch.telemetry import memory  # noqa: F401
from apex_tpu_torch.telemetry import numerics  # noqa: F401
from apex_tpu_torch.telemetry import recorder  # noqa: F401
from apex_tpu_torch.telemetry.attribution import (  # noqa: F401
    PipelineAttributor,
)
from apex_tpu_torch.telemetry.compile_watch import (  # noqa: F401
    CompileWatcher,
    RecompileError,
    assert_no_recompiles,
)
from apex_tpu_torch.telemetry.monitor import (  # noqa: F401
    AlertRule,
    JsonlTailer,
    Monitor,
    default_rules,
    parse_openmetrics,
    render_openmetrics,
)
from apex_tpu_torch.telemetry.memory import (  # noqa: F401
    HBMExhaustedError,
    MemoryBudgetError,
    live_buffer_census,
    oom_guard,
    oom_postmortem,
    preflight,
    step_memory,
)
from apex_tpu_torch.telemetry.numerics import (  # noqa: F401
    TensorStats,
    tensor_stats,
    tree_stats,
)
from apex_tpu_torch.telemetry.recorder import (  # noqa: F401
    FlightRecorder,
    RecorderState,
)
