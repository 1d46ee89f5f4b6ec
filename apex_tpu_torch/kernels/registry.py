"""Launch counters of the port's CUDA kernels.

Each kernel wrapper registers its name at import and adds one to its
count where it launches its kernel, and nowhere else: a call that takes
the plain PyTorch version (a CPU tensor) does not count. A run proves it
went through the kernels by resetting the counts before it and reading
them after. A CUDA graph's replay launches its kernels again without
calling the wrappers: the graph records the counts of its capture and
adds them on every replay (:func:`replayed`).

Unlike ``apex_tpu.kernels.registry`` there is no switch here that turns
a kernel off: on a CUDA tensor a wrapper launches its kernel or raises.
"""

_launches = {}


def register(name: str) -> str:
    """Add a kernel to the table (count 0); returns ``name``."""
    _launches.setdefault(name, 0)
    return name


def count(name: str) -> None:
    """One launch of kernel ``name``."""
    _launches[name] += 1


def launches() -> dict:
    """A copy of the counts, by kernel name."""
    return dict(_launches)


def reset() -> None:
    """Set every count to 0."""
    for name in _launches:
        _launches[name] = 0


def restore(counts: dict) -> None:
    """Set the counts to ``counts`` (from :func:`launches`): a CUDA graph's
    capture calls the wrappers, which count, but launches nothing."""
    _launches.update(counts)


def replayed(counts: dict) -> None:
    """One replay of a captured CUDA graph: it launches again every kernel
    its capture recorded, ``counts`` by name."""
    for name, n in counts.items():
        _launches[name] += n
