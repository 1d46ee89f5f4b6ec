"""Compile watch: make a silent recompile a first-class, observable event.

Counterpart of ``apex_tpu/telemetry/compile_watch.py``, with its
``compile`` events, ``compile/count``/``compile/seconds`` counters and
:func:`assert_no_recompiles` contract. The port compiles in three
places, and each reports here (:func:`note_compile`):

- a step function called with a new abstract signature (shapes,
  dtypes, devices, Python scalars): :meth:`CompileWatcher.watch` wraps
  it and counts the first call of each signature, naming on a later new
  signature exactly which argument changed (JAX's
  ``abstract_signature``/``diff_signatures``);
- each CUDA-graph capture of the serving engine's ladder
  (``serving/engine.py`` ``_capture_ladder``, through
  :meth:`CompileWatcher.record_aot`);
- each ``nvcc`` build of a kernel library (``kernels/_build.py``).

:func:`assert_no_recompiles` counts all three across a block and raises
:class:`RecompileError` when any happened. Opt-in: ``APEX_TPU_COMPILE_
WATCH=1`` enables the process-global watcher of :func:`get_watcher`; a
disabled watcher's ``watch`` returns the function unchanged, and
:func:`assert_no_recompiles` counts regardless.
"""

import contextlib
import os
import threading
import time

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.telemetry.registry import get_registry

ENV_WATCH = "APEX_TPU_COMPILE_WATCH"


class RecompileError(RuntimeError):
    """Raised by :func:`assert_no_recompiles` when a compile happened
    inside the guarded block."""


# -- process-wide compile accounting ----------------------------------------

_LOCK = threading.Lock()
_BACKEND = {"count": 0, "seconds": 0.0}


def note_compile(kind, name, seconds):
    """Count one compile of ``kind`` (``"signature"``, ``"cuda_graph"``,
    ``"nvcc"``) of ``name`` taking ``seconds``: the process-wide total
    of :func:`backend_compiles` and the ``compile/count`` /
    ``compile/seconds`` counters (a ``compile`` event for the kinds that
    no watcher records)."""
    with _LOCK:
        _BACKEND["count"] += 1
        _BACKEND["seconds"] += float(seconds)
    reg = get_registry()
    if reg.enabled:
        reg.counter("compile/count").inc()
        reg.counter("compile/seconds").inc(float(seconds))
        if kind == "nvcc":
            reg.event("compile", name, source=kind,
                      call_seconds=round(float(seconds), 6))


def backend_compiles():
    """``(count, total_seconds)`` of the compiles this process noted."""
    with _LOCK:
        return _BACKEND["count"], _BACKEND["seconds"]


# -- abstract signatures ----------------------------------------------------

def _describe_leaf(x):
    """One stable string per argument leaf: dtype, shape and device for a
    tensor (or a numpy array), the VALUE of a Python scalar or string,
    the type of anything else."""
    if isinstance(x, torch.Tensor):
        return (f"{str(x.dtype).replace('torch.', '')}{list(x.shape)}"
                f"@{x.device}")
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{getattr(dtype, 'name', dtype)}{list(shape)}"
    if isinstance(x, (bool, int, float, complex, str, bytes)):
        return f"py:{type(x).__name__}={x!r}"
    return f"static:{type(x).__name__}"


def abstract_signature(args, kwargs=None):
    """``{arg_path: descriptor}`` for a call's arguments. Paths are
    '/'-joined tree paths under ``args/<i>`` / ``kwargs/<name>``."""
    sig = {}
    for root, tree in (("args", tuple(args)),
                       ("kwargs", dict(kwargs or {}))):
        for path, leaf in _tree.flatten_with_path(tree):
            sig[f"{root}/{_tree.path_str(path)}"] = _describe_leaf(leaf)
    return sig


def diff_signatures(old, new):
    """Per-argument changes between two :func:`abstract_signature`
    dicts: ``[{"arg", "old", "new"}, ...]`` (``None`` marks an
    added/removed argument), sorted by argument path."""
    changes = []
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key), new.get(key)
        if a != b:
            changes.append({"arg": key, "old": a, "new": b})
    return changes


# -- the watcher ------------------------------------------------------------

class _FnStats:
    __slots__ = ("name", "signature", "seen", "compiles", "recompiles",
                 "compile_seconds", "last_change")

    def __init__(self, name):
        self.name = name
        self.signature = None
        self.seen = set()
        self.compiles = 0
        self.recompiles = 0
        self.compile_seconds = 0.0
        self.last_change = None


def _key(sig):
    return tuple(sorted(sig.items()))


class _WatchedFunction:
    """Host-side wrapper around one step function: its first call with
    each abstract signature is a compile. Delegates every other
    attribute to the wrapped function."""

    def __init__(self, fn, name, watcher):
        self._fn = fn
        self._name = name
        self._watcher = watcher
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        w = self._watcher
        if not w.enabled:
            return self._fn(*args, **kwargs)
        sig = abstract_signature(args, kwargs)
        rec = w.functions.setdefault(self._name, _FnStats(self._name))
        new = _key(sig) not in rec.seen
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if new:
            rec.seen.add(_key(sig))
            w._on_compile(self._name, sig, time.perf_counter() - t0)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


class CompileWatcher:
    """Compile accounting for step functions and the port's other
    compiles (host-side only).

    Usable as a plain object (``w = CompileWatcher(); step =
    w.watch(step)``), as a context manager (the exit emits a ``compile``
    summary event covering the block), and process-globally via
    :func:`get_watcher` + ``APEX_TPU_COMPILE_WATCH=1``. A disabled
    watcher's ``watch`` returns the function unchanged."""

    def __init__(self, *, enabled=None, registry=None):
        if enabled is None:
            enabled = os.environ.get(ENV_WATCH, "") not in ("", "0")
        self.enabled = bool(enabled)
        self._registry = registry
        self.functions = {}
        self._entered_at = None

    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def _reg(self):
        return self._registry or get_registry()

    def watch(self, fn, name=None):
        """Wrap ``fn`` so the first call of each abstract signature is
        counted, timed, and — when it is a recompile — signature-diffed.
        Returns ``fn`` itself when disabled."""
        if not self.enabled:
            return fn
        if name is None:
            name = getattr(fn, "__name__", None) or repr(fn)
        self.functions.setdefault(name, _FnStats(name))
        return _WatchedFunction(fn, name, self)

    def _on_compile(self, name, signature, call_seconds, kind="signature"):
        note_compile(kind, name, call_seconds)
        rec = self.functions.setdefault(name, _FnStats(name))
        rec.compiles += 1
        rec.compile_seconds += call_seconds
        changed = None
        if rec.signature is not None:  # a RE-compile: name the culprit
            rec.recompiles += 1
            changed = diff_signatures(rec.signature, signature)
            rec.last_change = changed
        rec.signature = signature
        rec.seen.add(_key(signature))
        reg = self._reg()
        if reg.enabled:
            reg.counter(f"compile/count/{name}").inc()
            reg.histogram("compile/call_seconds").observe(call_seconds)
            reg.event("compile", name,
                      compiles=rec.compiles,
                      recompile=rec.recompiles > 0 and changed is not None,
                      call_seconds=round(call_seconds, 6),
                      changed=changed, source=kind)

    def record_aot(self, name, args=(), kwargs=None, *, seconds=0.0):
        """Register an ahead-of-time compile under ``name``: the serving
        engine's capture of one CUDA graph. It lands in the same
        per-function stats, ``compile`` events and signature bookkeeping
        as a watched call, and counts as a compile for
        :func:`assert_no_recompiles` whether or not the watcher is
        enabled."""
        if not self.enabled:
            note_compile("cuda_graph", name, seconds)
            return
        self._on_compile(name, abstract_signature(args, kwargs), seconds,
                         kind="cuda_graph")

    def compile_count(self, name=None):
        """Compiles of one watched function (or the sum over all)."""
        if name is not None:
            rec = self.functions.get(name)
            return rec.compiles if rec else 0
        return sum(r.compiles for r in self.functions.values())

    def recompile_count(self):
        return sum(r.recompiles for r in self.functions.values())

    def last_changes(self):
        """``{fn_name: [{"arg", "old", "new"}, ...]}`` for every watched
        function whose latest compile was a signature-diffed recompile."""
        return {n: r.last_change for n, r in self.functions.items()
                if r.last_change}

    def __enter__(self):
        self.enable()
        self._entered_at = backend_compiles()
        return self

    def __exit__(self, *exc):
        count0, secs0 = self._entered_at or (0, 0.0)
        count1, secs1 = backend_compiles()
        reg = self._reg()
        if reg.enabled:
            reg.event("compile", "watch_summary",
                      backend_compiles=count1 - count0,
                      backend_compile_seconds=round(secs1 - secs0, 6),
                      watched={n: {"compiles": r.compiles,
                                   "recompiles": r.recompiles}
                               for n, r in self.functions.items()})
        return False


_GLOBAL = None
_GLOBAL_LOCK = threading.Lock()


def get_watcher():
    """The process-global watcher, created on first use — enabled iff
    ``APEX_TPU_COMPILE_WATCH`` was set at that point."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = CompileWatcher()
    return _GLOBAL


@contextlib.contextmanager
def assert_no_recompiles(watcher=None, *, allow=0):
    """Fail loudly if anything compiled inside the block: a watched
    function's new signature, a CUDA-graph capture, an ``nvcc`` build.
    Raises :class:`RecompileError` naming the changed argument when a
    watched function saw it. ``allow`` tolerates that many compiles."""
    watcher = watcher or get_watcher()
    before = backend_compiles()[0]
    marks = {n: r.recompiles for n, r in watcher.functions.items()}
    yield watcher
    delta = backend_compiles()[0] - before
    if delta <= allow:
        return
    detail = ""
    for name, rec in watcher.functions.items():
        if rec.recompiles > marks.get(name, 0) and rec.last_change:
            first = rec.last_change[0]
            detail = (f" Watched fn '{name}' recompiled: argument "
                      f"'{first['arg']}' changed "
                      f"{first['old']} -> {first['new']}.")
            break
    raise RecompileError(
        f"{delta} compile(s) happened inside an assert_no_recompiles "
        f"block (allowed {allow}) — something is recompiling per call; "
        f"check input shapes/dtypes and Python scalars reaching the "
        f"step, and graph captures.{detail}")
