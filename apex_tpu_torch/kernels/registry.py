"""Launch counters of the port's CUDA kernels, and the work they did.

Each kernel wrapper registers its name at import and adds one to its
count where it launches its kernel, and nowhere else: a call that takes
the plain PyTorch version (a CPU tensor) does not count. A run proves it
went through the kernels by resetting the counts before it and reading
them after. A CUDA graph's replay launches its kernels again without
calling the wrappers: the graph records the counts of its capture and
adds them on every replay (:func:`replayed`).

Beside its count, a wrapper adds the floating-point operations and the
bytes its launch does, reckoned from its shapes (each input read once,
each output written once, as PERF.md's bounds reckon them):
``torch.utils.flop_counter.FlopCounterMode`` cannot see a ``ctypes``
call, so :func:`apex_tpu_torch.telemetry.cost.step_cost` adds these
totals (:func:`work`) to what that mode counts. A graph replay adds the
launches its capture recorded, not their work.

Unlike ``apex_tpu.kernels.registry`` there is no switch here that turns
a kernel off: on a CUDA tensor a wrapper launches its kernel or raises.
"""

_launches = {}
_work = {}


def register(name: str) -> str:
    """Add a kernel to the table (count 0); returns ``name``."""
    _launches.setdefault(name, 0)
    _work.setdefault(name, [0.0, 0.0])
    return name


def count(name: str, *, flops: float = 0.0, bytes: float = 0.0) -> None:
    """One launch of kernel ``name``, doing ``flops`` operations over
    ``bytes`` bytes."""
    _launches[name] += 1
    w = _work[name]
    w[0] += float(flops)
    w[1] += float(bytes)


def launches() -> dict:
    """A copy of the counts, by kernel name."""
    return dict(_launches)


def work() -> dict:
    """``{name: {"flops", "bytes"}}``: what the counted launches did."""
    return {k: {"flops": f, "bytes": b} for k, (f, b) in _work.items()}


def reset() -> None:
    """Set every count, and every work total, to 0."""
    for name in _launches:
        _launches[name] = 0
        _work[name] = [0.0, 0.0]


def restore(counts: dict) -> None:
    """Set the counts to ``counts`` (from :func:`launches`): a CUDA graph's
    capture calls the wrappers, which count, but launches nothing."""
    _launches.update(counts)


def replayed(counts: dict) -> None:
    """One replay of a captured CUDA graph: it launches again every kernel
    its capture recorded, ``counts`` by name."""
    for name, n in counts.items():
        _launches[name] += n


def nbytes(*tensors) -> float:
    """Bytes of the tensors (lists of them flattened; None skipped): what
    a launch reads or writes once each."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return float(total)


def count_all(name: str, launches: int, *, flops: float = 0.0,
              bytes: float = 0.0) -> None:
    """``launches`` launches of kernel ``name`` that together did ``flops``
    and ``bytes`` (a multi-tensor call split into tables of 64)."""
    for _ in range(launches):
        count(name, flops=flops / launches, bytes=bytes / launches)
