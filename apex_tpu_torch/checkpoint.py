"""Checkpoint / resume for training state, with durability guarantees.

Counterpart of ``apex_tpu/checkpoint.py``, with its on-disk layout:
``directory/step_<N:010d>/state.pkl`` beside a ``manifest.json`` of
per-leaf path, shape, dtype and crc32 and per-file size and sha256, so
either package verifies the other's steps.

    from apex_tpu_torch import checkpoint
    checkpoint.save("ckpt/", step, params=model.state_dict(),
                    opt_state=opt.state_dict())
    state = checkpoint.restore("ckpt/")          # latest good step
    state = checkpoint.restore("ckpt/", step=5)  # specific step

The payload is numpy arrays in plain containers (dict, list, tuple,
Python scalars) — never a class of either package (a named tuple is
stored as a dict of its fields), so a checkpoint unpickles with numpy
alone. bf16 leaves are stored as their uint16 bits, with ``"bfloat16"``
as the manifest's dtype (numpy has no bf16 without ``ml_dtypes``); the
manifest's crc32 is of those bits, the same bytes the JAX package
checksums. :func:`restore` gives CPU tensors back. A checkpoint the JAX
package wrote restores here (its bf16 leaves need ``ml_dtypes`` to
unpickle), and one this package wrote without bf16 leaves restores
there.

Durability:

- every ``save`` writes the manifest inside the step dir, landing
  atomically with the data (a temp dir renamed into place);
- ``restore`` verifies files before decoding and leaves after, wraps any
  decode failure in :class:`CheckpointCorruptError`, and — on the resume
  path (``step=None``) — walks back through older steps with a loud
  warning naming what was rejected;
- transient write failures retry with exponential backoff + jitter
  (``retries`` / ``$APEX_TPU_CKPT_RETRIES``, telemetry counter
  ``checkpoint/write_retries``);
- ``keep_last_n`` prunes old steps only AFTER the new one landed and
  verified;
- :class:`AsyncCheckpointer` copies the state from the card into pinned
  host buffers on a side stream (the main stream waits for the copy
  before it may overwrite the tensors; the host does not), then writes
  on a thread.
"""

import concurrent.futures
import hashlib
import json
import os
import pickle
import random
import re
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.telemetry import trace as _telemetry_trace
from apex_tpu_torch.telemetry.registry import get_registry as _get_registry

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1
ENV_RETRIES = "APEX_TPU_CKPT_RETRIES"
BF16 = "bfloat16"

_LAST_RESTORE_META: Optional[Dict[str, Any]] = None


def last_restore_metadata() -> Optional[Dict[str, Any]]:
    """The audit record of this process's most recent successful
    :func:`restore`: ``{"directory", "requested_step", "settled_step",
    "rejected": [{"step", "error"}], "fallback_depth"}``. None before any
    restore."""
    return _LAST_RESTORE_META


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification or could not be
    decoded (torn write, bit flip, truncated pickle). The resume path
    (``restore(dir)``) catches this per step and falls back to the
    next-older checkpoint."""


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:010d}")


def _all_steps(directory: str):
    """Sorted (ascending) list of step numbers present in ``directory``."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest checkpointed step in ``directory``, or None."""
    steps = _all_steps(directory)
    return steps[-1] if steps else None


def repair_orphaned_steps(directory: str) -> list:
    """Recover steps stranded by a crash inside ``_write_state``'s
    force-overwrite window: a death between ``rename(path, old)`` and
    ``rename(tmp, path)`` leaves the step only as ``step_N.old-<pid>``,
    which ``latest_step`` rightly skips. Renames each such dir back when
    (and only when) the canonical ``step_N`` is absent — if both exist
    the landed checkpoint is newer and the parked copy stays parked.
    Called from ``save`` (single-writer discipline: don't run it while
    another process is mid-save in the same directory). Returns the
    recovered step numbers."""
    if not os.path.isdir(directory):
        return []
    recovered = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"(step_\d+)\.old-\d+", name)
        if not m:
            continue
        canonical = os.path.join(directory, m.group(1))
        if not os.path.exists(canonical):
            os.rename(os.path.join(directory, name), canonical)
            recovered.append(int(m.group(1)[len("step_"):]))
    return recovered


# ---------------------------------------------------------------------------
# host trees: tensors -> numpy (bf16 as uint16 bits) and back
# ---------------------------------------------------------------------------

def _tensor_to_numpy(t):
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.contiguous().numpy()


def _plain(tree):
    """Plain containers: named tuples as dicts of their fields."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def to_host(state):
    """``state`` as the payload stores it: plain containers, tensors as
    numpy arrays (bf16 as uint16 bits). Returns ``(host_state,
    bf16_paths)``, the manifest paths of the bf16 leaves."""
    bf16 = set()

    def conv(path, t):
        if isinstance(t, torch.Tensor):
            if t.dtype == torch.bfloat16:
                bf16.add(_leaf_path(path))
            return _tensor_to_numpy(t)
        return t

    return _tree.tree_map_with_path(conv, _plain(state)), bf16


def _key_str(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _leaf_path(path) -> str:
    return "/".join(_key_str(k) for k in path)


def _leaf_fingerprint(leaf, bf16=False):
    """(crc32, dtype name, shape list) of one host-side leaf. Arrays
    checksum their raw bytes (a bf16 leaf's uint16 bits, named
    ``"bfloat16"``); anything numpy can't type falls back to its
    repr."""
    arr = np.asarray(leaf)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        return zlib.crc32(repr(leaf).encode()), "object", []
    name = BF16 if bf16 and arr.dtype == np.uint16 else arr.dtype.name
    # the array's own buffer (no copy; the bytes of tobytes())
    return (zlib.crc32(np.ascontiguousarray(arr)), name, list(arr.shape))


def _manifest_for(host_state, bf16_paths=()) -> Dict[str, Any]:
    """The integrity manifest for a host-side state tree: its structure,
    and per-leaf path/shape/dtype/crc32 (the crc32s on a few threads:
    zlib releases the GIL over a large buffer)."""
    flat = [(_leaf_path(path), leaf)
            for path, leaf in _tree.flatten_with_path(host_state)]
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1)) as pool:
        prints = list(pool.map(
            lambda pl: _leaf_fingerprint(pl[1], pl[0] in bf16_paths), flat))
    leaves = [{"path": p, "shape": shape, "dtype": dtype, "crc32": crc}
              for (p, _), (crc, dtype, shape) in zip(flat, prints)]
    return {"format": MANIFEST_FORMAT, "writer": "pickle",
            "num_leaves": len(leaves),
            "treedef": str(_tree.structure(host_state)),
            "leaves": leaves}


def _bf16_paths(manifest):
    if not manifest:
        return set()
    return {e["path"] for e in manifest.get("leaves", ())
            if e.get("dtype") == BF16}


def _contiguous(a):
    # np.ascontiguousarray would make a 0-d array 1-d
    return a if a.flags.c_contiguous else a.copy()


def _bf16_tensor(bits):
    return torch.from_numpy(_contiguous(bits).view(np.int16)).view(
        torch.bfloat16)


def from_host(host_state, bf16_paths=()):
    """A restored payload as the port holds it: array leaves as CPU
    tensors (uint16 leaves the manifest names bf16, and the ``ml_dtypes``
    bf16 arrays of a JAX-written payload, as ``torch.bfloat16``); Python
    scalars and strings as they are."""
    def conv(path, leaf):
        if not isinstance(leaf, np.ndarray):
            return leaf
        if leaf.dtype.name == BF16:  # ml_dtypes, from the JAX package
            return _bf16_tensor(leaf.view(np.uint16))
        if leaf.dtype == np.uint16 and _leaf_path(path) in bf16_paths:
            return _bf16_tensor(leaf)
        if leaf.dtype == object or leaf.dtype.kind in ("U", "S"):
            return leaf
        return torch.from_numpy(_contiguous(leaf))

    return _tree.tree_map_with_path(conv, host_state)


# ---------------------------------------------------------------------------
# manifest: per-leaf checksums + per-file hashes
# ---------------------------------------------------------------------------

def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The step's manifest, None when absent (pre-manifest checkpoint),
    CheckpointCorruptError when present but unreadable."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable {MANIFEST_NAME} ({e})") from e


def _verify_files(path: str, manifest: Dict[str, Any]) -> None:
    """Byte-level integrity: every manifest-listed file exists with the
    recorded size and sha256 (catches torn writes before a decoder sees
    the bytes)."""
    for rel, info in (manifest.get("files") or {}).items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            raise CheckpointCorruptError(f"{path}: payload file {rel} "
                                         "missing")
        size = os.path.getsize(full)
        if size != info.get("size"):
            raise CheckpointCorruptError(
                f"{path}: {rel} is {size} bytes, manifest recorded "
                f"{info.get('size')} (torn write?)")
        h = hashlib.sha256()
        with open(full, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != info.get("sha256"):
            raise CheckpointCorruptError(
                f"{path}: {rel} sha256 mismatch (bit corruption?)")


def _verify_tree(restored, manifest: Dict[str, Any], path: str) -> None:
    """Logical integrity: the restored payload's leaves match the
    manifest (count, and per-path shape/dtype/crc32). Where the path
    names differ the comparison degrades to the multiset of leaf
    fingerprints."""
    want = manifest.get("leaves")
    if want is None:
        return
    got = _manifest_for(restored, _bf16_paths(manifest))["leaves"]
    if len(got) != len(want):
        raise CheckpointCorruptError(
            f"{path}: restored {len(got)} leaves, manifest recorded "
            f"{len(want)}")
    want_by_path = {e["path"]: e for e in want}
    got_by_path = {e["path"]: e for e in got}
    if set(want_by_path) == set(got_by_path):
        for p, w in want_by_path.items():
            g = got_by_path[p]
            for field in ("shape", "dtype", "crc32"):
                if g[field] != w[field]:
                    raise CheckpointCorruptError(
                        f"{path}: leaf {p!r} {field} mismatch "
                        f"(restored {g[field]!r}, manifest {w[field]!r})")
    else:
        fp = lambda e: (e["dtype"], tuple(e["shape"]), e["crc32"])  # noqa: E731
        if sorted(map(fp, got)) != sorted(map(fp, want)):
            raise CheckpointCorruptError(
                f"{path}: restored leaf set does not match manifest "
                "(content checksums differ)")


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Shallow verification of a landed step dir: the manifest parses
    and every payload file matches its recorded size/sha256. Raises
    :class:`CheckpointCorruptError` (manifest absent counts as a
    failure — this is the gate retention uses before pruning). Returns
    the manifest."""
    manifest = _read_manifest(path)
    if manifest is None:
        raise CheckpointCorruptError(f"{path}: no {MANIFEST_NAME}")
    _verify_files(path, manifest)
    return manifest


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save(directory: str, step: int, state: Optional[Dict[str, Any]] = None,
         *, retries: Optional[int] = None, retry_base_delay: float = 0.05,
         keep_last_n: Optional[int] = None, **extra: Any) -> str:
    """Snapshot ``state`` (a dict of trees, merged with ``extra`` kwargs)
    under ``directory/step_N``, with a ``manifest.json`` of content
    checksums landing atomically alongside the data.

    ``retries`` transient-write retries (default ``$APEX_TPU_CKPT_RETRIES``
    or 2) run with exponential backoff + jitter. ``keep_last_n`` prunes
    older steps — only after this one verified. Returns the checkpoint
    path. Tensors are copied to the host first (blocking)."""
    state = {**(state or {}), **extra}
    path = _step_dir(directory, step)
    with _telemetry_trace.span("checkpoint/save", step=step):
        os.makedirs(directory, exist_ok=True)
        repair_orphaned_steps(directory)
        host_state = to_host(state)
        _write_state_with_retries(path, host_state, retries=retries,
                                  retry_base_delay=retry_base_delay)
        if keep_last_n is not None:
            verify_checkpoint(path)  # never prune behind an unverified save
            _prune_old_steps(directory, keep_last_n)
    return path


def _write_state_with_retries(path: str, host_state, *,
                              retries: Optional[int] = None,
                              retry_base_delay: float = 0.05) -> None:
    """``_write_state`` with exponential backoff + jitter on transient
    failures. ``retries`` counts re-attempts after the first try; the
    final failure re-raises. Each retry lands a
    ``checkpoint/write_retries`` counter tick and a warning."""
    if retries is None:
        retries = int(os.environ.get(ENV_RETRIES, "2"))
    attempt = 0
    while True:
        try:
            # module-global lookup on purpose: the fault injectors
            # (resilience.faults) patch checkpoint._write_state
            return _write_state(path, host_state)
        except Exception as e:
            if attempt >= retries:
                raise
            delay = retry_base_delay * (2 ** attempt)
            delay += random.uniform(0, delay)  # jitter: desync replicas
            attempt += 1
            reg = _get_registry()
            if reg.enabled:
                reg.counter("checkpoint/write_retries").inc()
                reg.event("checkpoint", "write_retry", path=path,
                          attempt=attempt, error=str(e)[:200])
            warnings.warn(
                f"checkpoint: write attempt {attempt}/{retries + 1} for "
                f"{path} failed ({type(e).__name__}: {e}); retrying in "
                f"{delay:.2f}s")
            time.sleep(delay)


def _prune_old_steps(directory: str, keep_last_n: int) -> list:
    """Retention: delete all but the newest ``keep_last_n`` steps.
    Only called after the newest step verified (see :func:`save`).
    Returns the pruned step numbers."""
    import shutil

    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    steps = _all_steps(directory)
    pruned = steps[:-keep_last_n]
    for s in pruned:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    if pruned:
        reg = _get_registry()
        if reg.enabled:
            reg.counter("checkpoint/steps_pruned").inc(len(pruned))
            reg.event("checkpoint", "pruned", steps=pruned,
                      kept=keep_last_n)
    return pruned


def restore(directory: str, step: Optional[int] = None, *,
            verify: bool = True,
            fallback: Optional[bool] = None,
            with_metadata: bool = False):
    """Load the state dict saved by :func:`save`.

    ``step=None`` loads the newest step — and, when that step fails
    verification or decoding (:class:`CheckpointCorruptError`), walks
    back through older steps with a loud warning naming what was
    rejected and why, until one verifies (``fallback`` defaults to True
    on the resume path, False for an explicit ``step``). ``verify=False``
    skips manifest verification entirely (not recommended outside
    debugging). Array leaves come back as CPU tensors (bf16 ones
    included, from their stored bits), Python scalars as they were.
    Raises FileNotFoundError when no checkpoints exist.

    ``with_metadata=True`` returns ``(state, metadata)`` where
    metadata is the audit record of what was *actually* loaded —
    ``settled_step``, the ``rejected`` ``[{"step", "error"}]`` the
    fallback chain walked past, and ``fallback_depth`` — so a
    supervisor (or a human reading the logs) can see that "resumed"
    meant "resumed from an OLDER step". The same record is always
    kept at :func:`last_restore_metadata`, and a non-empty fallback
    additionally lands the ``checkpoint/restore_fallback_step`` gauge
    + a ``restore_fallback`` event in the registry.
    """
    global _LAST_RESTORE_META
    if fallback is None:
        fallback = step is None
    if step is None:
        # The resume flow is where a step stranded mid-overwrite (crash
        # between _write_state's two renames) would otherwise silently
        # resolve to an OLDER step — recover parked dirs first. (Under
        # the single-writer discipline repair_orphaned_steps documents,
        # a concurrent writer mid-rename-window would fail its landing
        # rename loudly rather than lose data silently.)
        repair_orphaned_steps(directory)
        candidates = _all_steps(directory)[::-1]  # newest first
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    else:
        candidates = [step]
    rejected = []
    for i, s in enumerate(candidates):
        try:
            restored = _restore_step(directory, s, verify=verify)
            meta = {
                "directory": directory,
                "requested_step": step,
                "settled_step": s,
                "rejected": [{"step": rs, "error": str(re)[:300]}
                             for rs, re in rejected],
                "fallback_depth": len(rejected),
            }
            _LAST_RESTORE_META = meta
            if rejected:
                reg = _get_registry()
                if reg.enabled:
                    reg.gauge("checkpoint/restore_fallback_step").set(s)
                    reg.event("checkpoint", "restore_fallback",
                              settled_step=s,
                              rejected_steps=[r["step"]
                                              for r in meta["rejected"]])
            return (restored, meta) if with_metadata else restored
        except CheckpointCorruptError as e:
            if not fallback:
                raise
            rejected.append((s, e))
            reg = _get_registry()
            if reg.enabled:
                reg.counter("checkpoint/restore_rejected").inc()
                reg.event("checkpoint", "restore_rejected", step=s,
                          error=str(e)[:300])
            older = candidates[i + 1] if i + 1 < len(candidates) else None
            warnings.warn(
                f"checkpoint: REJECTED step {s} under {directory} — "
                f"{e} — "
                + (f"falling back to step {older}" if older is not None
                   else "no older step to fall back to"))
    raise CheckpointCorruptError(
        f"every checkpoint under {directory} failed to load: "
        + "; ".join(f"step {s}: {e}" for s, e in rejected))


def _restore_step(directory: str, step: int, *,
                  verify: bool = True) -> Dict[str, Any]:
    """Load + verify one step. Any integrity or decode failure —
    manifest/file mismatch, unpickle error, a step dir with no payload —
    surfaces as :class:`CheckpointCorruptError`."""
    path = _step_dir(directory, step)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint dir {path}")
    manifest = _read_manifest(path)
    pkl = os.path.join(path, "state.pkl")
    with _telemetry_trace.span("checkpoint/restore", step=step):
        if manifest is not None and verify:
            _verify_files(path, manifest)
        elif manifest is None and verify:
            warnings.warn(
                f"checkpoint: {path} has no {MANIFEST_NAME} "
                "(pre-manifest checkpoint?) — loading without integrity "
                "verification")
        if not os.path.exists(pkl):
            raise CheckpointCorruptError(f"{path}: state.pkl missing")
        try:
            with open(pkl, "rb") as f:
                restored = pickle.load(f)
        except Exception as e:
            raise CheckpointCorruptError(
                f"{path}: state.pkl failed to unpickle "
                f"({type(e).__name__}: {str(e)[:300]})") from e
        if manifest is not None and verify:
            _verify_tree(restored, manifest, path)
    return from_host(restored, _bf16_paths(manifest))


class _HashingWriter:
    """A file's ``write`` that also feeds a sha256 and counts the bytes."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()
        self.size = 0

    def write(self, data):
        self.sha.update(data)
        self.size += memoryview(data).nbytes
        return self._f.write(data)


def _write_state(path: str, host_state) -> None:
    """Write into a temp dir — payload first, then the integrity
    manifest — then rename to ``path``: ``latest_step``'s ``step_N``
    fullmatch skips the temp name, so a concurrent ``restore(dir)`` never
    selects a checkpoint whose bytes are still landing, and the manifest
    is atomically present for every landed step. ``host_state`` is
    :func:`to_host`'s ``(tree, bf16_paths)``."""
    import shutil

    tree, bf16 = host_state
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    try:
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            out = _HashingWriter(f)
            pickle.dump(tree, out, protocol=pickle.HIGHEST_PROTOCOL)
        manifest = _manifest_for(tree, bf16)
        # the payload's sha256 as it was written (no second read); the
        # verify before pruning reads the landed bytes back
        manifest["files"] = {"state.pkl": {"size": out.size,
                                           "sha256": out.sha.hexdigest()}}
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
        old = None
        if os.path.exists(path):
            # force-overwrite: park the old dir under a non-matching name
            # first so a crash between the two renames leaves the data
            # recoverable and never a half-deleted step dir
            old = f"{path}.old-{os.getpid()}"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint serialization with the next training steps.

    ``save`` queues the copy of every CUDA tensor into pinned host
    buffers on a side stream (after the work already queued on the
    current stream) and makes the current stream wait for the copy, so
    the next step overwrites the tensors only after it; the host does
    not wait. A thread then waits for the copy and writes the payload
    with the blocking :func:`save`'s durability path (manifest, retries,
    ``keep_last_n`` retention gated on post-landing verification). One
    checkpoint is in flight at a time: a new ``save`` first waits for
    the previous write (whose pinned buffers it then reuses), and a
    failed write re-raises on the next ``save`` / ``wait_until_finished``
    / ``close``. A failed write never lands its step dir.

        ckptr = AsyncCheckpointer(keep_last_n=2)
        for step in range(n):
            train_step()
            if step % 100 == 0:
                ckptr.save("ckpt/", step, params=model.state_dict(), ...)
        ckptr.wait_until_finished()
    """

    def __init__(self, *, retries: Optional[int] = None,
                 retry_base_delay: float = 0.05,
                 keep_last_n: Optional[int] = None,
                 _pre_write_hook: Optional[Callable[[], None]] = None):
        self._retries = retries
        self._retry_base_delay = retry_base_delay
        self._keep_last_n = keep_last_n
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="apex_tpu_torch_ckpt")
        self._future: Optional[concurrent.futures.Future] = None
        self._lock = threading.Lock()
        self._pre_write_hook = _pre_write_hook
        self._pinned = {}   # (position, shape, dtype) -> pinned buffer
        self._stream = None
        # the last landed write's seconds (copy wait excluded) and bytes
        self.last_write_seconds = None
        self.last_bytes = None

    def _snapshot(self, state):
        """``state`` with every CUDA tensor replaced by the pinned host
        buffer its copy was queued into, and the event that marks the
        copies done (None without CUDA tensors)."""
        cuda = [l for l in _tree.leaves(state)
                if isinstance(l, torch.Tensor) and l.device.type == "cuda"]
        if not cuda:
            return state, None
        device = cuda[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        self._stream.wait_stream(main)
        position = [0]

        def copy(t):
            if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
                return t
            key = (position[0], tuple(t.shape), t.dtype)
            position[0] += 1
            buf = self._pinned.get(key)
            if buf is None:
                buf = self._pinned[key] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t.detach(), non_blocking=True)
            return buf

        with torch.cuda.stream(self._stream):
            host = _tree.tree_map(copy, state)
            done = torch.cuda.Event()
            done.record(self._stream)
        main.wait_stream(self._stream)
        return host, done

    def save(self, directory: str, step: int,
             state: Optional[Dict[str, Any]] = None, **extra: Any) -> str:
        """Queue the copy to the host now, write in the background;
        returns the checkpoint path immediately."""
        with self._lock:
            self._join_locked()
            merged = {**(state or {}), **extra}
            path = _step_dir(directory, step)
            os.makedirs(directory, exist_ok=True)
            repair_orphaned_steps(directory)
            with _telemetry_trace.span("checkpoint/snapshot", step=step):
                snap, done = self._snapshot(merged)

            def job():
                if done is not None:
                    done.synchronize()
                if self._pre_write_hook is not None:
                    self._pre_write_hook()
                t0 = time.perf_counter()
                with _telemetry_trace.span("checkpoint/async_write",
                                           step=step):
                    _write_state_with_retries(
                        path, to_host(snap), retries=self._retries,
                        retry_base_delay=self._retry_base_delay)
                    if self._keep_last_n is not None:
                        verify_checkpoint(path)
                        _prune_old_steps(directory, self._keep_last_n)
                self.last_write_seconds = time.perf_counter() - t0
                self.last_bytes = os.path.getsize(
                    os.path.join(path, "state.pkl"))

            self._future = self._pool.submit(job)
            return path

    def wait_until_finished(self) -> None:
        """Block until the in-flight write (if any) has landed; re-raises
        its error."""
        with self._lock:
            self._join_locked()

    def _join_locked(self) -> None:
        if self._future is not None:
            fut, self._future = self._future, None
            fut.result()  # propagate background-write failures

    def close(self) -> None:
        try:
            self.wait_until_finished()  # re-raises a failed write
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def save_training_state(directory: str, step: int, params, opt_state,
                        batch_stats=None, extra=None, topology=None,
                        scaler=None, **kw) -> str:
    """Bundle the common training tuple: ``params`` (a module's
    ``state_dict``), ``opt_state`` (an optimizer's ``state_dict``),
    ``step``, and the loss scaler's ``state_dict`` under ``"amp"``
    (``scaler``'s, else amp's own where it was initialized).
    ``topology`` records the WRITING topology (``{"world": 8, ...}``)
    for an elastic restore."""
    state = {"params": params, "opt_state": opt_state, "step": step}
    if batch_stats is not None:
        state["batch_stats"] = batch_stats
    if extra is not None:
        state["extra"] = extra
    if topology is not None:
        state["topology"] = {k: v for k, v in dict(topology).items()}
    try:
        if scaler is not None:
            state["amp"] = scaler.state_dict()
        else:
            from apex_tpu_torch import amp

            state["amp"] = amp.state_dict()
    except Exception as e:
        warnings.warn(f"checkpoint: amp state not saved ({e})")
    return save(directory, step, state, **kw)


def restore_training_state(directory: str, step: Optional[int] = None,
                           scaler=None, **kw):
    """Load what :func:`save_training_state` wrote. The ``"amp"`` entry
    goes back into ``scaler`` (else amp's own scaler) when present; the
    caller loads ``state["params"]`` and ``state["opt_state"]`` into its
    module and optimizer. ``with_metadata=True`` returns ``(state,
    metadata)``."""
    out = restore(directory, step, **kw)
    state, meta = out if kw.get("with_metadata") else (out, None)
    if "amp" in state:
        try:
            if scaler is not None:
                scaler.load_state_dict(state["amp"])
            else:
                from apex_tpu_torch import amp

                amp.load_state_dict(state["amp"])
        except Exception as e:
            warnings.warn(
                f"checkpoint: amp scaler state failed to load ({e}); "
                "resuming with the current scaler — loss scale may differ "
                "from the saved run")
    return (state, meta) if meta is not None else state
