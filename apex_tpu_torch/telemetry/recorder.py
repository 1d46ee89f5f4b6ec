"""Step flight recorder: a device-side ring of per-module statistics.

Counterpart of ``apex_tpu/telemetry/recorder.py``, with its post-mortem
file and format. When ``check_guard`` escalates to ``NonFiniteError``
after K consecutive skipped steps, the run would die with no record of
which layer went bad or how its norms trended into the blow-up. The
:class:`FlightRecorder` keeps the last K steps of
:func:`~apex_tpu_torch.telemetry.numerics.tree_stats` on the card as one
fp32 ``[K, G, 9]`` tensor: :meth:`record` writes one row in place at
``cursor % K`` with device indexing (no host synchronisation, no copy),
and the host reads the ring exactly once, when something already went
wrong: :meth:`dump_postmortem` writes ``numerics-postmortem-rank<N>.json``
naming the first module prefix whose non-finite count is > 0, with the
prior steps' (finite) trend alongside.

Recording is unconditional by design: ``guarded_update`` records the
step's statistics whether or not the step commits, so the poisoned
step's statistics are in the ring for the post-mortem.

Env knobs: ``APEX_TPU_NUMERICS_RING`` (ring length, default 8),
``APEX_TPU_NUMERICS_DIR`` (post-mortem directory; falls back to the
telemetry JSONL dir, then the CWD).
"""

import json
import os
import time
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.telemetry import numerics
from apex_tpu_torch.telemetry.registry import _process_index, get_registry

ENV_RING = "APEX_TPU_NUMERICS_RING"
ENV_DIR = "APEX_TPU_NUMERICS_DIR"
DEFAULT_RING_LENGTH = 8
POSTMORTEM_BASENAME = "numerics-postmortem-rank{rank}.json"


def default_ring_length() -> int:
    return int(os.environ.get(ENV_RING, str(DEFAULT_RING_LENGTH)))


class RecorderState(NamedTuple):
    """The device-resident ring: ``buffer`` fp32 ``[K, G, 9]`` (one row of
    :class:`~apex_tpu_torch.telemetry.numerics.TensorStats` a group a
    step), ``steps`` int32 ``[K]`` (-1 = never written), ``cursor`` int32
    ``[]`` (lifetime records; the next slot is ``cursor % K``), and the
    groups' ``keys`` (host strings, sorted)."""

    buffer: torch.Tensor
    steps: torch.Tensor
    cursor: torch.Tensor
    keys: tuple


class FlightRecorder:
    """Ring-buffer policy object (host-side; the state is a
    :class:`RecorderState`).

    ``length`` is the ring capacity K (default
    ``$APEX_TPU_NUMERICS_RING`` or 8); ``prefix_depth`` is the
    module-prefix grouping depth used when ``guarded_update`` derives
    statistics itself (default ``$APEX_TPU_NUMERICS_DEPTH`` or 2).
    """

    def __init__(self, length: Optional[int] = None,
                 prefix_depth: Optional[int] = None):
        self.length = default_ring_length() if length is None else int(length)
        if self.length < 1:
            raise ValueError(f"FlightRecorder: length must be >= 1, "
                             f"got {self.length}")
        self.prefix_depth = (numerics.default_prefix_depth()
                             if prefix_depth is None else int(prefix_depth))
        self.last_postmortem = None

    # -- state ----------------------------------------------------------

    def init_state(self, tree, prefixes=None, device=None) -> RecorderState:
        """Zeroed ring shaped for ``tree``: the gradient (or parameter)
        tree the step will record statistics of, or an already computed
        ``{prefix: TensorStats}`` dict. ``prefixes`` mirrors the
        namespacing the step will record (``("grads", "synced")`` for
        ``DistributedDataParallel(numerics=...)``'s statistics). Only
        the tree's paths are read; nothing is computed."""
        if isinstance(tree, dict) and tree and all(
                isinstance(v, numerics.TensorStats) for v in tree.values()):
            keys = sorted(tree)
            leaf = next(iter(tree.values())).l2
            device = device or getattr(leaf, "device", None)
        else:
            keys = set()
            for pre in (prefixes or (None,)):
                keys.update(numerics.grouping(
                    tree, self.prefix_depth, prefix=pre)[0])
            keys = sorted(keys)
            if device is None:
                from apex_tpu_torch import _tree

                leaves = [l for l in _tree.leaves(tree)
                          if isinstance(l, torch.Tensor)]
                device = leaves[0].device if leaves else None
        device = torch.device("cpu") if device is None else device
        return RecorderState(
            buffer=torch.zeros((self.length, len(keys),
                                len(numerics.STAT_FIELDS)),
                               dtype=torch.float32, device=device),
            steps=torch.full((self.length,), -1, dtype=torch.int32,
                             device=device),
            cursor=torch.zeros((), dtype=torch.int32, device=device),
            keys=tuple(keys))

    def record(self, state: RecorderState, step, stats) -> RecorderState:
        """Write one step's ``{prefix: TensorStats}`` into the ring slot
        ``cursor % K`` (evicting the oldest row once full) and advance the
        cursor, in place on the device: no host synchronisation. ``step``
        is a host int or a device int tensor. Returns ``state``."""
        if tuple(sorted(stats)) != state.keys:
            raise ValueError(
                f"FlightRecorder.record: statistics for groups "
                f"{sorted(stats)} do not match the ring's {list(state.keys)}")
        table = numerics.stats_table(stats).to(state.buffer.dtype)
        idx = torch.remainder(state.cursor, self.length).reshape(1).long()
        state.buffer.index_copy_(0, idx, table.unsqueeze(0))
        if isinstance(step, torch.Tensor):
            step_t = step.to(device=state.steps.device,
                             dtype=torch.int32).reshape(1)
        else:
            step_t = torch.full((1,), int(step), dtype=torch.int32,
                                device=state.steps.device)
        state.steps.index_copy_(0, idx, step_t)
        state.cursor.add_(1)
        return state

    # -- host side ------------------------------------------------------

    def fetch(self, state: RecorderState):
        """ONE device->host transfer of the whole ring, unrolled into
        rows oldest -> newest: ``[{"step": int, "stats": {prefix:
        {field: float}}}, ...]`` (at most K rows; fewer before the ring
        fills)."""
        packed = torch.cat([state.buffer.reshape(-1).double(),
                            state.steps.double(),
                            state.cursor.reshape(1).double()]).cpu()
        k, g, f = state.buffer.shape
        buffer = packed[:k * g * f].view(k, g, f).tolist()
        steps = packed[k * g * f:k * g * f + k].tolist()
        cursor = int(packed[-1])
        count = min(cursor, self.length)
        rows = []
        for j in range(count):
            i = (cursor - count + j) % self.length
            rows.append({
                "step": int(steps[i]),
                "stats": {
                    prefix: {name: float(buffer[i][gi][fi])
                             for fi, name in enumerate(numerics.STAT_FIELDS)}
                    for gi, prefix in enumerate(state.keys)},
            })
        return rows

    @staticmethod
    def first_nonfinite(rows):
        """Scan rows oldest -> newest for the first module prefix whose
        non-finite count is > 0; returns ``(step, prefix)`` or
        ``(None, None)`` when the whole ring is finite."""
        for row in rows:
            prefix = numerics.first_nonfinite_prefix(row["stats"])
            if prefix is not None:
                return row["step"], prefix
        return None, None

    def resolve_dir(self, directory=None, registry=None):
        if directory:
            return directory
        env = os.environ.get(ENV_DIR)
        if env:
            return env
        reg = registry or get_registry()
        return reg.jsonl_dir or "."

    def dump_postmortem(self, state: RecorderState, directory=None, *,
                        reason="guard_skip", registry=None, extra=None):
        """Fetch the ring once and write
        ``numerics-postmortem-rank<N>.json`` (atomic tmp+rename;
        overwrites — the newest wreckage is the one that matters).
        Returns the record dict (with ``"path"``) and remembers it as
        ``self.last_postmortem``; also lands a ``numerics`` event in
        the registry when enabled."""
        rows = self.fetch(state)
        step, prefix = self.first_nonfinite(rows)
        rank = _process_index()
        directory = self.resolve_dir(directory, registry)
        record = {
            "t": round(time.time(), 6),
            "reason": reason,
            "rank": rank,
            "ring_length": self.length,
            "prefix_depth": self.prefix_depth,
            "first_nonfinite_step": step,
            "first_nonfinite_prefix": prefix,
            "rows": rows,
        }
        if extra:
            record.update(extra)
        path = os.path.join(directory,
                            POSTMORTEM_BASENAME.format(rank=rank))
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(record, f, indent=1)
            os.replace(tmp, path)
            record["path"] = path
        except OSError:
            # an unwritable post-mortem dir must never mask the
            # escalation that triggered the dump
            record["path"] = None
        reg = registry or get_registry()
        if reg.enabled:
            reg.event("numerics", "postmortem", reason=reason,
                      path=record["path"], rows=len(rows),
                      first_nonfinite_step=step,
                      first_nonfinite_prefix=prefix)
        self.last_postmortem = record
        return record
