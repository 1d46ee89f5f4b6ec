"""HBM budget accounting: know the peak before the card finds out.

Counterpart of ``apex_tpu/telemetry/memory.py``, with its reports,
gauges, events and post-mortem file. XLA's ``memory_analysis()`` has no
counterpart in PyTorch, so the port measures:

- :func:`step_memory` runs ``fn`` once between
  ``torch.cuda.reset_peak_memory_stats()`` and
  ``torch.cuda.max_memory_allocated()``: the bytes live before the call
  (``argument_bytes``), what it left allocated (``output_bytes``), its
  peak, the card's capacity and the ``headroom_frac`` that lands in the
  ``memory/hbm_headroom`` gauge. Every report joins an in-process
  headroom trend. A CPU run has no allocator statistics: it returns
  None, as the JAX package does where a backend offers no analysis.
- :func:`live_buffer_census` lists the live CUDA storages (found through
  the garbage collector's tensors, each storage counted once, by its
  bytes), grouped by label, shape and dtype; ``labels`` maps a name to
  a tree of tensors, matched by storage.
- :func:`preflight` compares a measured peak against capacity: a
  warning, or :class:`MemoryBudgetError` with ``strict=True``.
- :func:`oom_postmortem` / :func:`oom_guard` catch an out-of-memory
  error (``torch.cuda.OutOfMemoryError``, or the resilience fault
  ``SyntheticResourceExhausted``) and write an atomic
  ``memory-postmortem-rank<N>.json`` (census + last step_memory report +
  headroom trend), then re-raise as :class:`HBMExhaustedError`. A real
  OOM leaves the caching allocator's blocks reserved: the guard empties
  the cache after the post-mortem, before the next step runs.

Env knobs: ``APEX_TPU_HBM_GB`` (capacity override, in GB),
``APEX_TPU_MEMORY_DIR`` (post-mortem directory; falls back to the
telemetry JSONL dir, then the CWD).
"""

import collections
import contextlib
import gc
import json
import os
import time
import warnings

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.telemetry.registry import _process_index, get_registry

ENV_HBM_GB = "APEX_TPU_HBM_GB"
ENV_DIR = "APEX_TPU_MEMORY_DIR"
POSTMORTEM_BASENAME = "memory-postmortem-rank{rank}.json"
TREND_LENGTH = 64
# the host's stand-in capacity where there is no card
CPU_CAPACITY_BYTES = int(16e9)


class MemoryBudgetError(RuntimeError):
    """Raised by ``preflight(strict=True)`` when the measured peak
    exceeds capacity: fail before the traffic, not in the middle of
    it."""


class HBMExhaustedError(RuntimeError):
    """Raised by :func:`oom_guard` after an out-of-memory error killed a
    step and the memory post-mortem landed — the OOM sibling of
    ``resilience.NonFiniteError``."""


def _backend():
    return "gpu" if torch.cuda.is_available() else "cpu"


def hbm_capacity_bytes(device=None):
    """The card's memory in bytes. Resolution order: ``$APEX_TPU_HBM_GB``
    (decimal GB) > the CUDA device's ``total_memory`` >
    :data:`CPU_CAPACITY_BYTES` without a card."""
    env = os.environ.get(ENV_HBM_GB)
    if env:
        return int(float(env) * 1e9)
    if torch.cuda.is_available():
        dev = torch.device("cuda") if device is None else torch.device(device)
        if dev.type == "cuda":
            return int(torch.cuda.get_device_properties(
                dev.index if dev.index is not None
                else torch.cuda.current_device()).total_memory)
    return CPU_CAPACITY_BYTES


# -- step memory accounting -------------------------------------------------

_LAST_REPORT = None
_TREND = collections.deque(maxlen=TREND_LENGTH)


def headroom_trend():
    """The last ``TREND_LENGTH`` step-memory snapshots, oldest first:
    ``[{"t", "peak_bytes", "headroom_frac"}, ...]``."""
    return list(_TREND)


def reset_trend():
    """Drop the trend + last report (test isolation)."""
    global _LAST_REPORT
    _LAST_REPORT = None
    _TREND.clear()


def record_report(report, *, registry=None):
    """Land a memory report: the ``memory/peak_hbm_bytes`` and
    ``memory/hbm_headroom`` gauges, a ``memory`` event and the headroom
    trend. Returns ``report``."""
    global _LAST_REPORT
    _LAST_REPORT = report
    _TREND.append({"t": round(time.time(), 6),
                   "peak_bytes": report["peak_bytes"],
                   "headroom_frac": report["headroom_frac"]})
    reg = registry or get_registry()
    if reg.enabled:
        reg.gauge("memory/peak_hbm_bytes").set(report["peak_bytes"])
        if report["headroom_frac"] is not None:
            reg.gauge("memory/hbm_headroom").set(report["headroom_frac"])
        fields = dict(report)
        fields["step"] = fields.pop("name")  # "name" is the event's
        reg.event("memory", "step_memory", **fields)
    return report


def make_report(name, *, peak_bytes, argument_bytes=0, output_bytes=0,
                temp_bytes=0, capacity_bytes=None, device=None):
    """A report dict in the JAX package's layout from measured bytes."""
    capacity = hbm_capacity_bytes(device) if capacity_bytes is None \
        else int(capacity_bytes)
    return {
        "name": name,
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(output_bytes),
        "temp_bytes": int(temp_bytes),
        "generated_code_bytes": 0,
        "alias_bytes": 0,
        "peak_bytes": int(peak_bytes),
        "capacity_bytes": capacity,
        "headroom_frac": 1.0 - peak_bytes / capacity if capacity else None,
        "backend": _backend(),
    }


def step_memory(fn, *args, registry=None, record=True, name=None,
                device=None, **kwargs):
    """Memory report of one call of ``fn(*args, **kwargs)`` on the card:
    it runs ``fn`` once, fenced, between ``reset_peak_memory_stats`` and
    ``max_memory_allocated``. ``argument_bytes`` is what was allocated
    before, ``output_bytes`` what the call left allocated on top,
    ``temp_bytes`` the peak's excess over both. Returns None without a
    card (a CPU run has no allocator statistics)."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    if name is None:
        name = getattr(fn, "__name__", None) or "step"
    report = make_report(name, peak_bytes=peak, argument_bytes=before,
                         output_bytes=max(after - before, 0),
                         temp_bytes=max(peak - max(before, after), 0),
                         device=dev)
    if record:
        record_report(report, registry=registry)
    return report


# -- live buffer census -----------------------------------------------------

def _storage_key(t):
    try:
        return (str(t.device), t.untyped_storage().data_ptr())
    except Exception:
        return None


def _live_tensors(device_type):
    with warnings.catch_warnings():
        # isinstance on some objects (deprecated module attributes) warns
        warnings.simplefilter("ignore")
        objs = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    for obj in objs:
        try:
            if obj.device.type == device_type:
                yield obj
        except Exception:
            continue


def live_buffer_census(top_k=10, *, labels=None, device_type=None):
    """Group the process's live storages on the card (the host's without
    one) into a top-K table by bytes: ``{"total_arrays", "total_bytes",
    "groups": [{"label", "shape", "dtype", "count", "bytes"}, ...],
    "dropped_groups", "dropped_bytes"}``. Each storage counts once, at
    its size, under the shape and dtype of the first tensor found on it.
    ``labels`` maps group names to trees of tensors, matched by storage
    (``labels={"masters": ..., "moments": ...}``); unmatched storages
    group under ``"<anon>"``."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    key_to_label = {}
    for label, tree in (labels or {}).items():
        for leaf in _tree.leaves(tree):
            if isinstance(leaf, torch.Tensor):
                key = _storage_key(leaf)
                if key is not None:
                    key_to_label.setdefault(key, label)
    seen = set()
    groups = {}
    total_bytes = 0
    total_arrays = 0
    for t in _live_tensors(device_type):
        key = _storage_key(t)
        if key is None or key in seen:
            continue
        seen.add(key)
        try:
            nbytes = int(t.untyped_storage().nbytes())
        except Exception:
            continue
        gkey = (key_to_label.get(key, "<anon>"), tuple(t.shape),
                str(t.dtype).replace("torch.", ""))
        g = groups.setdefault(gkey, {"count": 0, "bytes": 0})
        g["count"] += 1
        g["bytes"] += nbytes
        total_bytes += nbytes
        total_arrays += 1
    rows = [{"label": label, "shape": list(shape), "dtype": dtype,
             "count": g["count"], "bytes": g["bytes"]}
            for (label, shape, dtype), g in groups.items()]
    rows.sort(key=lambda r: (-r["bytes"], r["label"], r["dtype"]))
    kept = rows[:top_k] if top_k else rows
    return {
        "total_arrays": total_arrays,
        "total_bytes": total_bytes,
        "groups": kept,
        "dropped_groups": max(0, len(rows) - len(kept)),
        "dropped_bytes": sum(r["bytes"] for r in rows[len(kept):]),
    }


# -- preflight --------------------------------------------------------------

def judge(report, *, strict=False, capacity_bytes=None, safety_frac=0.0,
          registry=None, what="this step"):
    """Compare a report's peak against the budget (``capacity_bytes``, by
    default the report's capacity, less ``safety_frac``): adds
    ``budget_bytes`` and ``over_budget``; over budget it lands a
    ``preflight_over_budget`` event and warns, or raises
    :class:`MemoryBudgetError` with ``strict=True``."""
    capacity = capacity_bytes if capacity_bytes is not None \
        else report["capacity_bytes"]
    budget = int(capacity * (1.0 - safety_frac))
    report = dict(report, budget_bytes=budget,
                  over_budget=report["peak_bytes"] > budget)
    if report["over_budget"]:
        msg = (f"measured peak {report['peak_bytes'] / 1e9:.2f} GB "
               f"exceeds the {budget / 1e9:.2f} GB budget "
               f"({capacity / 1e9:.2f} GB capacity, "
               f"{safety_frac:.0%} safety margin) — {what} will run out "
               f"of memory; shrink the batch, the slots or the ladder, or "
               f"shard the optimizer state (ZeRO)")
        reg = registry or get_registry()
        if reg.enabled:
            reg.event("memory", "preflight_over_budget",
                      peak_bytes=report["peak_bytes"],
                      budget_bytes=budget, capacity_bytes=capacity)
        if strict:
            raise MemoryBudgetError(msg)
        warnings.warn(msg, stacklevel=3)
    return report


def preflight(fn, *args, strict=False, capacity_bytes=None,
              safety_frac=0.0, registry=None, **kwargs):
    """Measure the step's peak (:func:`step_memory`, one call of ``fn``)
    and complain when it exceeds capacity: a warning by default, a
    :class:`MemoryBudgetError` with ``strict=True``. ``safety_frac``
    reserves a fraction of capacity for fragmentation. Returns the
    report (None without a card — never a false alarm)."""
    report = step_memory(fn, *args, registry=registry, **kwargs)
    if report is None:
        return None
    return judge(report, strict=strict, capacity_bytes=capacity_bytes,
                 safety_frac=safety_frac, registry=registry)


# -- OOM post-mortem --------------------------------------------------------

def is_oom_error(exc):
    """True when ``exc`` is a memory exhaustion: a
    ``torch.cuda.OutOfMemoryError``, or the synthetic one
    ``faults.inject_alloc_failure`` raises (its message carries
    ``RESOURCE_EXHAUSTED``, so the post-mortem path runs on the CPU)."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text
            or "Out of memory" in text
            or "out of memory" in text)


def resolve_dir(directory=None, registry=None):
    if directory:
        return directory
    env = os.environ.get(ENV_DIR)
    if env:
        return env
    reg = registry or get_registry()
    return reg.jsonl_dir or "."


# the most recent post-mortem record (with "path") — lets callers
# (bench, smoke stages) find what oom_guard dumped on their behalf,
# mirroring FlightRecorder.last_postmortem
_LAST_POSTMORTEM = None


def last_postmortem():
    """The most recent :func:`oom_postmortem` record this process wrote
    (None before the first)."""
    return _LAST_POSTMORTEM


def oom_postmortem(error=None, directory=None, *, registry=None,
                   census=None, labels=None, extra=None):
    """Write ``memory-postmortem-rank<N>.json`` (atomic tmp+rename;
    overwrites — the newest wreckage is the one that matters):
    the live-buffer census at death, the last :func:`step_memory`
    report, and the headroom trend — mirroring the numerics post-mortem
    format. Returns the record dict (with ``"path"``); also lands a
    ``memory`` event in the registry when enabled."""
    rank = _process_index()
    directory = resolve_dir(directory, registry)
    record = {
        "t": round(time.time(), 6),
        "reason": "resource_exhausted",
        "rank": rank,
        "error": None if error is None else
        f"{type(error).__name__}: {str(error)[:2000]}",
        "census": census if census is not None
        else live_buffer_census(labels=labels),
        "last_step_memory": _LAST_REPORT,
        "headroom_trend": headroom_trend(),
        "capacity_bytes": hbm_capacity_bytes(),
    }
    if extra:
        record.update(extra)
    path = os.path.join(directory, POSTMORTEM_BASENAME.format(rank=rank))
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, path)
        record["path"] = path
    except OSError:
        # an unwritable post-mortem dir must never mask the OOM itself
        record["path"] = None
    reg = registry or get_registry()
    if reg.enabled:
        reg.event("memory", "postmortem", path=record["path"],
                  error=record["error"],
                  census_bytes=record["census"]["total_bytes"],
                  trend_points=len(record["headroom_trend"]))
    global _LAST_POSTMORTEM
    _LAST_POSTMORTEM = record
    return record


@contextlib.contextmanager
def oom_guard(directory=None, *, registry=None, labels=None):
    """Run a block (typically one train step and its host read) under
    the OOM post-mortem handler: an out-of-memory error escaping the
    block writes the post-mortem, empties the allocator's cache and
    re-raises as :class:`HBMExhaustedError` (with the original as
    ``__cause__``); every other exception passes through untouched."""
    try:
        yield
    except Exception as e:
        if isinstance(e, HBMExhaustedError) or not is_oom_error(e):
            raise
        record = oom_postmortem(e, directory, registry=registry,
                                labels=labels)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            # the failed allocation left the caching allocator's blocks
            # reserved: hand them back before the next step
            torch.cuda.empty_cache()
        raise HBMExhaustedError(
            f"step hit RESOURCE_EXHAUSTED (out of memory) — the card is "
            f"over budget, not transiently busy. Memory post-mortem (live-buffer census + "
            f"headroom trend): "
            f"{record['path'] or '<unwritable dir>'}.") from e
