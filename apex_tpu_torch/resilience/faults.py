"""Deterministic fault injection for the resilience chaos suite.

Counterpart of ``apex_tpu/resilience/faults.py``: the same fault plan,
env keys, injectors and error types, over tensors (``inject_nan``
poisons a tree of tensors with ``torch.where`` on the step, no host
synchronisation when the step is a device tensor) and over the port's
checkpoint writer (``apex_tpu_torch.checkpoint._write_state``).

Every injector is explicit and deterministic — a fault fires at the
step / call you named, never randomly — so a chaos test is a regular
regression test. Gating is API-first (call the injector) with one env
escape hatch for end-to-end drills:

- ``APEX_TPU_FAULT_PLAN`` — the consolidated fault spec, a
  ``;``-separated list of ``kind@step[:arg]`` entries parsed by
  :func:`parse_fault_plan` / read by :func:`fault_plan`::

      APEX_TPU_FAULT_PLAN="nan@3:layer1;alloc@5;preempt@9"

  Kinds: ``nan`` (arg = module-path prefix filter), ``alloc``,
  ``preempt``, ``device_loss`` (arg = shrink-to world),
  ``decode`` (arg = ``transient``/``persistent``), ``slot_nan``
  (arg = slot id), ``ckpt_torn``, ``ckpt_fail`` (step = failure
  count). Every ``*_from_env`` helper consults the plan, so one
  var scripts a whole chaos campaign.

The pre-plan per-injector vars still work — ``APEX_TPU_FAULT_NAN_STEP``,
``_ALLOC_STEP``, ``_CKPT_WRITE_FAILURES``, ``_SLOT_NAN``,
``_DECODE_STEP``/``_TRANSIENT`` — but are DEPRECATED in favor of the
plan (one ``DeprecationWarning`` per var per process); when both name
the same fault the legacy var wins, so existing drills keep their
meaning.

Injector catalogue:

- :func:`inject_nan` — NaN poisoning of a gradient tree at one chosen
  step (a ``torch.where`` on a device step counter, or a host compare on
  a host step; the identity when not armed).
- :func:`inject_alloc_failure` — host-side synthetic
  ``RESOURCE_EXHAUSTED`` at one chosen step (a real HBM exhaustion is
  raised by the runtime at dispatch, so the injector fires on the host
  just before it), making the OOM post-mortem path
  (``telemetry.memory.oom_guard`` / ``resilience.guarded_call``)
  testable on CPU — the allocation sibling of :func:`inject_nan`.
- :func:`failing_checkpoint_writes` — the next N checkpoint writes die
  after flushing a few real payload bytes into the temp location
  (transient disk/FS failure; nothing lands, exercising the retry path
  and ``AsyncCheckpointer`` error surfacing).
- :func:`torn_checkpoint_write` — the next checkpoint write LANDS, but
  with a truncated ``state.pkl`` behind a manifest describing the full
  intended bytes (a crash/power-cut that lost the file tail):
  ``restore`` must reject the step and fall back.
- :func:`corrupt_checkpoint` — flip bytes in a landed checkpoint's
  payload in place (bit rot / torn sector).
- :func:`simulate_preemption` — raise a real SIGTERM in-process, which
  a :class:`~apex_tpu_torch.resilience.preemption.PreemptionGuard` fields.

Serving injectors (all deterministic,
keyed on the engine's lifetime decode-call counter):

- :func:`inject_slot_nan` — poison ONE slot's decode logits at one
  decode call (``APEX_TPU_FAULT_SLOT_NAN="slot:step"``). The engine
  packs the armed slot id into its decode graph's static input buffer
  (identity at -1), so arming never recaptures a graph — the per-slot
  quarantine path runs under ``assert_no_recompiles``.
- :func:`inject_decode_failure` — fail a decode *dispatch* host-side
  at one decode call (``APEX_TPU_FAULT_DECODE_STEP``), transient
  (fires once; the retry succeeds) or permanent (fires on every
  attempt until the retry budget exhausts and the engine raises
  ``serving.robust.DecodeFailedError``).
- :func:`request_storm` — a burst trace (every request arriving at
  the same tick) for admission-control drills: with a bounded pending
  queue the overflow must shed, not grow without bound.

Fleet injectors:

- :func:`inject_replica_loss` — kill ONE serving replica at one fleet
  step (``APEX_TPU_FAULT_PLAN="replica_loss@N:R"``): the fleet's
  router polls :func:`replica_loss_for` each tick, drops the named
  replica's engine, and must migrate its unfinished requests to
  survivors (re-prefill from prompt + emitted tokens) — the
  replica-level sibling of :func:`inject_device_loss`, keyed on the
  fleet's lifetime step counter the way the serving injectors key on
  the decode-call counter. One-shot: the respawned replica is clean.
"""

import contextlib
import os
import pickle
import signal
import warnings

import numpy as np
import torch

from apex_tpu_torch import _tree

ENV_FAULT_PLAN = "APEX_TPU_FAULT_PLAN"
ENV_NAN_STEP = "APEX_TPU_FAULT_NAN_STEP"
ENV_CKPT_WRITE_FAILURES = "APEX_TPU_FAULT_CKPT_WRITE_FAILURES"
ENV_ALLOC_STEP = "APEX_TPU_FAULT_ALLOC_STEP"
ENV_SLOT_NAN = "APEX_TPU_FAULT_SLOT_NAN"
ENV_DECODE_STEP = "APEX_TPU_FAULT_DECODE_STEP"
ENV_DECODE_TRANSIENT = "APEX_TPU_FAULT_DECODE_TRANSIENT"

#: every spec kind ``parse_fault_plan`` accepts, with the meaning of
#: the optional ``:arg`` suffix (None = no arg defined for the kind)
PLAN_KINDS = {
    "nan": "module-path prefix filter (inject_nan path_filter)",
    "alloc": None,
    "preempt": None,
    "device_loss": "shrink-to world size for the mesh-shrink restart",
    "decode": "'transient' (default) or 'persistent'",
    "slot_nan": "slot id to poison (default 0)",
    "ckpt_torn": None,
    "ckpt_fail": None,  # step field = number of failing writes
    "replica_loss": "fleet replica index to kill (default 0)",
    "kv_corrupt": "donor replica index whose migration payload is "
                  "corrupted (default 0)",
}


class FaultInjected(OSError):
    """The error raised by injected I/O faults — distinguishable from a
    real failure in test assertions."""


class SyntheticResourceExhausted(FaultInjected):
    """Injected allocation failure. The message carries the literal
    ``RESOURCE_EXHAUSTED`` marker so ``telemetry.memory.is_oom_error``
    treats it exactly like the XLA runtime error it stands in for."""


class InjectedDecodeFailure(FaultInjected):
    """Injected decode-dispatch failure. ``transient`` distinguishes a
    blip (fires once; the engine's retry must succeed) from a
    persistent fault (fires every attempt; the retry budget must
    exhaust). The message carries ``UNAVAILABLE`` so
    ``serving.robust.is_retryable_decode_error`` classifies it exactly
    like the runtime error it stands in for."""

    def __init__(self, msg, *, transient=True):
        super().__init__(msg)
        self.transient = bool(transient)


class DeviceLostError(RuntimeError):
    """Injected device/slice loss. The message carries the literal
    ``DEVICE_LOST`` marker (what a runtime surfaces when a
    slice drops out), so ``resilience.supervisor.classify_failure``
    routes it to the mesh-shrink policy. ``shrink_to`` optionally names
    the world size the surviving mesh should restart at (None = let the
    policy decide, typically world // 2)."""

    def __init__(self, msg, *, shrink_to=None):
        super().__init__(msg)
        self.shrink_to = shrink_to


# -- the consolidated fault plan --------------------------------------------

class FaultPlan:
    """A parsed ``APEX_TPU_FAULT_PLAN`` spec: ``entries`` maps kind ->
    ``{"kind", "step", "arg"}``. One entry per kind (a campaign names
    each fault class at most once — sweep classes across runs, not
    within one)."""

    def __init__(self, entries=None, spec=""):
        self.entries = dict(entries or {})
        self.spec = spec

    def get(self, kind):
        """The entry dict for ``kind``, or None when the plan does not
        name that fault class."""
        return self.entries.get(kind)

    def step(self, kind):
        """The armed step for ``kind``, or None."""
        e = self.entries.get(kind)
        return e["step"] if e else None

    def __bool__(self):
        return bool(self.entries)

    def __repr__(self):
        return f"FaultPlan({self.spec!r})"


def parse_fault_plan(spec):
    """Parse one ``kind@step[:arg]``-list spec (``;``-separated) into a
    :class:`FaultPlan`. Raises ValueError naming the offending entry on
    an unknown kind, a non-integer step, or a duplicate kind."""
    entries = {}
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, at, rest = raw.partition("@")
        kind = kind.strip()
        if not at or kind not in PLAN_KINDS:
            known = ", ".join(sorted(PLAN_KINDS))
            raise ValueError(
                f"{ENV_FAULT_PLAN}: bad entry {raw!r} — want "
                f"'kind@step[:arg]' with kind in ({known})")
        step_s, _, arg = rest.partition(":")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(
                f"{ENV_FAULT_PLAN}: entry {raw!r} has a non-integer "
                f"step {step_s!r}") from None
        if kind in entries:
            raise ValueError(
                f"{ENV_FAULT_PLAN}: duplicate entry for kind "
                f"{kind!r} ({raw!r}); name each fault class once")
        entries[kind] = {"kind": kind, "step": step,
                         "arg": arg if arg != "" else None}
    return FaultPlan(entries, spec or "")


def fault_plan():
    """The plan parsed from ``$APEX_TPU_FAULT_PLAN`` (re-read on every
    call — cheap, and monkeypatched envs in tests stay honest). An
    unset/empty var yields an empty plan that gates nothing."""
    return parse_fault_plan(os.environ.get(ENV_FAULT_PLAN, ""))


_legacy_warned = set()


def _legacy_env_step(var, plan_kind):
    """Read a deprecated per-injector step var, warning once per var
    per process that the consolidated plan supersedes it. The legacy
    var wins over a plan entry of the same kind (existing drills keep
    their meaning); returns None when unset."""
    v = os.environ.get(var)
    if v in (None, ""):
        return None
    if var not in _legacy_warned:
        _legacy_warned.add(var)
        warnings.warn(
            f"{var} is deprecated — express the fault in "
            f"{ENV_FAULT_PLAN} instead (e.g. "
            f"'{plan_kind}@{v}'); the legacy var still wins when both "
            "are set", DeprecationWarning, stacklevel=3)
    return int(v)


def nan_step_from_env():
    """The step to poison per ``$APEX_TPU_FAULT_NAN_STEP`` (deprecated)
    or the plan's ``nan@N`` entry, or None."""
    legacy = _legacy_env_step(ENV_NAN_STEP, "nan")
    if legacy is not None:
        return legacy
    return fault_plan().step("nan")


def nan_path_from_env():
    """The module-path prefix filter of the plan's ``nan@N:prefix``
    entry, or None (poison everything). The legacy var has no path
    field, so this is plan-only."""
    e = fault_plan().get("nan")
    return e["arg"] if e else None


def alloc_step_from_env():
    """The step to OOM per ``$APEX_TPU_FAULT_ALLOC_STEP`` (deprecated)
    or the plan's ``alloc@N`` entry, or None."""
    legacy = _legacy_env_step(ENV_ALLOC_STEP, "alloc")
    if legacy is not None:
        return legacy
    return fault_plan().step("alloc")


def preempt_step_from_env():
    """The step to deliver the simulated SIGTERM at, per the plan's
    ``preempt@N`` entry (plan-only — no legacy var existed), or None.
    Read by the training loop's caller: preemption is a signal, not a
    fault inside the step, so the caller owns the delivery."""
    return fault_plan().step("preempt")


def device_loss_spec_from_env():
    """``(step, shrink_to)`` of the plan's ``device_loss@N[:world]``
    entry, or ``(None, None)``."""
    e = fault_plan().get("device_loss")
    if not e:
        return None, None
    return e["step"], int(e["arg"]) if e["arg"] else None


def inject_device_loss(step, device_loss_step=None, *, shrink_to=None,
                       world=None):
    """Raise :class:`DeviceLostError` when ``step ==
    device_loss_step`` (host-side — a real device loss kills the
    dispatch, so the injector fires just before it, the topology
    sibling of :func:`inject_alloc_failure`). ``device_loss_step=None``
    consults the plan's ``device_loss@N[:world]`` entry; still None
    means no injection. ``shrink_to`` (default: the plan's arg, else
    None) rides on the error so the supervisor's mesh-shrink policy
    knows the surviving world size."""
    if device_loss_step is None:
        device_loss_step, plan_shrink = device_loss_spec_from_env()
        if shrink_to is None:
            shrink_to = plan_shrink
    if device_loss_step is None or int(step) != int(device_loss_step):
        return
    detail = f" (world was {int(world)})" if world else ""
    raise DeviceLostError(
        f"DEVICE_LOST: injected device loss at step {int(step)}{detail} "
        f"(faults.inject_device_loss)", shrink_to=shrink_to)


def inject_alloc_failure(step, alloc_step=None, *, bytes_requested=None):
    """Raise a synthetic ``RESOURCE_EXHAUSTED`` when ``step ==
    alloc_step`` (host-side — call it in the train loop just before the
    step dispatch, inside the ``oom_guard``/``guarded_call`` whose
    post-mortem path is under test). ``alloc_step=None`` consults
    ``$APEX_TPU_FAULT_ALLOC_STEP``; still None means no injection —
    safe to leave in production loops, mirroring :func:`inject_nan`."""
    if alloc_step is None:
        alloc_step = alloc_step_from_env()
    if alloc_step is None or int(step) != int(alloc_step):
        return
    detail = (f" while allocating {int(bytes_requested)} bytes"
              if bytes_requested else "")
    raise SyntheticResourceExhausted(
        f"RESOURCE_EXHAUSTED: injected allocation failure at step "
        f"{int(step)}{detail} (faults.inject_alloc_failure)")


def inject_nan(tree, step, nan_step=None, path_filter=None):
    """Poison every floating leaf of ``tree`` with NaN when ``step ==
    nan_step`` (``step`` a host int, or a device tensor: then a
    ``torch.where`` on it, no host synchronisation); identity for other
    steps and when no step is armed. ``nan_step=None`` consults the env
    var; still None means no injection — safe to leave in production
    step functions.

    ``path_filter`` targets the fault at a single module: a string is
    matched as a prefix of each leaf's '/'-joined path (the same path
    formatting ``telemetry.numerics.tree_stats`` groups by), a callable
    receives the path string and returns whether to poison. Leaves that
    don't match pass through untouched."""
    if nan_step is None:
        nan_step = nan_step_from_env()
        if path_filter is None:
            # the plan's nan@N:prefix arg targets the fault for free
            path_filter = nan_path_from_env()
    if nan_step is None:
        return tree

    if path_filter is None:
        def match(path_str):
            return True
    elif callable(path_filter):
        match = path_filter
    else:
        def match(path_str, _prefix=str(path_filter)):
            return path_str.startswith(_prefix)

    def poison(path, leaf):
        if not isinstance(leaf, torch.Tensor) or \
                not leaf.is_floating_point() or \
                not match(_tree.path_str(path)):
            return leaf
        if not isinstance(step, torch.Tensor):
            return torch.full_like(leaf, float("nan")) \
                if int(step) == int(nan_step) else leaf
        return torch.where(step.to(leaf.device) == int(nan_step),
                           torch.full_like(leaf, float("nan")), leaf)

    return _tree.tree_map_with_path(poison, tree)


@contextlib.contextmanager
def failing_checkpoint_writes(failures=None, after_bytes=64):
    """Make the next ``failures`` checkpoint writes fail after writing
    ``after_bytes`` of the real pickle payload into the temp location
    (the partial-write fault). The canonical step dir never appears, so
    ``latest_step`` must never select the failed step. Yields a dict
    whose ``"fired"`` counts injected failures."""
    from apex_tpu_torch import checkpoint

    if failures is None:
        legacy = os.environ.get(ENV_CKPT_WRITE_FAILURES)
        if legacy not in (None, ""):
            if ENV_CKPT_WRITE_FAILURES not in _legacy_warned:
                _legacy_warned.add(ENV_CKPT_WRITE_FAILURES)
                warnings.warn(
                    f"{ENV_CKPT_WRITE_FAILURES} is deprecated — use "
                    f"{ENV_FAULT_PLAN}='ckpt_fail@{legacy}'",
                    DeprecationWarning, stacklevel=3)
            failures = int(legacy)
        else:
            failures = fault_plan().step("ckpt_fail")
            if failures is None:
                failures = 1
    real = checkpoint._write_state
    stats = {"fired": 0}

    def fake(path, host_state):
        if stats["fired"] < failures:
            stats["fired"] += 1
            tmp = f"{path}.tmp-fault"
            os.makedirs(tmp, exist_ok=True)
            payload = pickle.dumps(host_state[0])
            with open(os.path.join(tmp, "state.pkl"), "wb") as f:
                f.write(payload[:after_bytes])
            raise FaultInjected(
                f"injected write failure #{stats['fired']} after "
                f"{min(after_bytes, len(payload))} bytes ({path})")
        return real(path, host_state)

    checkpoint._write_state = fake
    try:
        yield stats
    finally:
        checkpoint._write_state = real


@contextlib.contextmanager
def torn_checkpoint_write(keep_bytes=64):
    """Make the next checkpoint write land a TRUNCATED ``state.pkl``
    behind a manifest describing the full intended payload — the
    durable wreckage of a crash that lost the file tail. The step IS
    visible to ``latest_step``; only manifest verification can tell it
    from a good one. Yields a dict whose ``"fired"`` flags firing."""
    import json

    from apex_tpu_torch import checkpoint

    real = checkpoint._write_state
    stats = {"fired": 0}

    def fake(path, host_state):
        if stats["fired"]:
            return real(path, host_state)
        stats["fired"] = 1
        tree, bf16 = host_state  # checkpoint.to_host's pair
        payload = pickle.dumps(tree, protocol=pickle.HIGHEST_PROTOCOL)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "state.pkl"), "wb") as f:
            f.write(payload[:keep_bytes])
        manifest = checkpoint._manifest_for(tree, bf16)
        manifest["files"] = {
            "state.pkl": {"size": len(payload),
                          "sha256": checkpoint._sha256_bytes(payload)}}
        with open(os.path.join(path, checkpoint.MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)

    checkpoint._write_state = fake
    try:
        yield stats
    finally:
        checkpoint._write_state = real


def corrupt_checkpoint(directory, step, *, offset=-8, nbytes=4):
    """Flip ``nbytes`` bytes of a landed checkpoint's payload in place
    (negative ``offset`` counts from the file end). Targets
    ``state.pkl`` when present, else the largest payload file.
    Returns the corrupted file's path."""
    from apex_tpu_torch import checkpoint

    path = checkpoint._step_dir(directory, step)
    target = os.path.join(path, "state.pkl")
    if not os.path.exists(target):
        candidates = []
        for root, _, names in os.walk(path):
            for nm in names:
                if nm == checkpoint.MANIFEST_NAME:
                    continue
                full = os.path.join(root, nm)
                candidates.append((os.path.getsize(full), full))
        if not candidates:
            raise FileNotFoundError(f"no payload files under {path}")
        target = max(candidates)[1]
    with open(target, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        pos = f.tell()
        data = f.read(nbytes)
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in data))
    return target


# -- serving injectors ----------------------------------------------------
#
# Armed state is module-level so the engine (which owns the decode-call
# counter) and the caller (which owns the scenario) need no plumbing
# between them; ``arm_*``/context-manager both write the same slot.

_slot_nan_state = None      # {"slot", "step", "fired"}
_decode_fail_state = None   # {"step", "transient", "fired"}


def _slot_nan_from_env():
    v = os.environ.get(ENV_SLOT_NAN)
    if v not in (None, ""):
        if ENV_SLOT_NAN not in _legacy_warned:
            _legacy_warned.add(ENV_SLOT_NAN)
            slot_s, _, step_s = v.partition(":")
            warnings.warn(
                f"{ENV_SLOT_NAN} is deprecated — use "
                f"{ENV_FAULT_PLAN}='slot_nan@{step_s or 0}:{slot_s}'",
                DeprecationWarning, stacklevel=3)
        slot, _, step = v.partition(":")
        return {"slot": int(slot), "step": int(step or 0), "fired": 0}
    e = fault_plan().get("slot_nan")
    if e is None:
        return None
    return {"slot": int(e["arg"] or 0), "step": e["step"], "fired": 0}


def arm_slot_nan(slot, step):
    """Arm a one-shot slot-NaN: the decode call numbered ``step`` (the
    engine's lifetime decode-call counter, 0-based) poisons the logits
    of cache slot ``slot`` on the device. Returns the armed-state dict
    (``"fired"`` counts firings). Overwrites any previous arming."""
    global _slot_nan_state
    _slot_nan_state = {"slot": int(slot), "step": int(step), "fired": 0}
    return _slot_nan_state


def disarm_slot_nan():
    global _slot_nan_state
    _slot_nan_state = None


@contextlib.contextmanager
def inject_slot_nan(slot, step):
    """Context-manager form of :func:`arm_slot_nan`; disarms on exit.
    Yields the state dict so tests can assert ``state["fired"] == 1``."""
    state = arm_slot_nan(slot, step)
    try:
        yield state
    finally:
        disarm_slot_nan()


def poison_slot_for(decode_step):
    """The slot id to poison at decode call ``decode_step``, or -1.

    Called by ``ServeEngine.decode`` on every dispatch; the returned
    int feeds the decode step's ``poison`` input
    (identity at -1 — the unarmed fast path costs one ``is None``).
    One-shot: a matching call marks the arming fired so the NEXT
    decode call is clean — the quarantine must recover, not re-poison.
    Env arming (``APEX_TPU_FAULT_SLOT_NAN=slot:step``) is read lazily
    on first consult and follows the same one-shot contract."""
    global _slot_nan_state
    if _slot_nan_state is None and (ENV_SLOT_NAN in os.environ
                                    or fault_plan().get("slot_nan")):
        _slot_nan_state = _slot_nan_from_env()
    st = _slot_nan_state
    if not st or st["fired"] or int(decode_step) != st["step"]:
        return -1
    st["fired"] += 1
    return st["slot"]


def arm_decode_failure(step, transient=None):
    """Arm a decode-dispatch failure at decode call ``step``.
    ``transient=True`` (default) fires once — the engine's first retry
    finds clean air; ``transient=False`` fires on every attempt at
    that step, exhausting the retry budget. Returns the state dict."""
    global _decode_fail_state
    if transient is None:
        transient = os.environ.get(ENV_DECODE_TRANSIENT, "1") != "0"
    _decode_fail_state = {"step": int(step), "transient": bool(transient),
                          "fired": 0}
    return _decode_fail_state


def disarm_decode_failure():
    global _decode_fail_state
    _decode_fail_state = None


@contextlib.contextmanager
def inject_decode_failure(step, transient=True):
    """Context-manager form of :func:`arm_decode_failure`; disarms on
    exit. Yields the state dict (``"fired"`` counts raises)."""
    state = arm_decode_failure(step, transient=transient)
    try:
        yield state
    finally:
        disarm_decode_failure()


def maybe_fail_decode(decode_step):
    """Raise :class:`InjectedDecodeFailure` when a failure is armed for
    decode call ``decode_step`` — called by ``ServeEngine.decode``
    just before each dispatch attempt (the host-side stand-in for the
    runtime raising at dispatch). Transient armings clear after one
    raise; permanent ones keep raising at their step. Env arming via
    ``APEX_TPU_FAULT_DECODE_STEP`` (+ ``..._TRANSIENT=0`` for the
    permanent flavor) is read lazily on first consult."""
    global _decode_fail_state
    if _decode_fail_state is None:
        v = os.environ.get(ENV_DECODE_STEP)
        if v not in (None, ""):
            if ENV_DECODE_STEP not in _legacy_warned:
                _legacy_warned.add(ENV_DECODE_STEP)
                warnings.warn(
                    f"{ENV_DECODE_STEP} is deprecated — use "
                    f"{ENV_FAULT_PLAN}='decode@{v}'",
                    DeprecationWarning, stacklevel=2)
            arm_decode_failure(int(v))
        else:
            e = fault_plan().get("decode")
            if e is not None:
                arm_decode_failure(
                    e["step"], transient=(e["arg"] != "persistent"))
    st = _decode_fail_state
    if not st or int(decode_step) != st["step"]:
        return
    if st["transient"] and st["fired"]:
        return
    st["fired"] += 1
    raise InjectedDecodeFailure(
        f"UNAVAILABLE: injected {'transient' if st['transient'] else 'persistent'} "
        f"decode failure at decode call {int(decode_step)} "
        f"(attempt {st['fired']}; faults.inject_decode_failure)",
        transient=st["transient"])


_replica_loss_state = None   # {"replica", "step", "fired"}


def arm_replica_loss(replica, step):
    """Arm a one-shot replica loss: at fleet step ``step`` (the
    fleet's lifetime step counter, 0-based) replica ``replica`` drops
    dead — its engine becomes unusable and every unfinished request
    must finish on a survivor. Returns the armed-state dict
    (``"fired"`` counts firings). Overwrites any previous arming."""
    global _replica_loss_state
    _replica_loss_state = {"replica": int(replica), "step": int(step),
                           "fired": 0}
    return _replica_loss_state


def disarm_replica_loss():
    global _replica_loss_state
    _replica_loss_state = None


@contextlib.contextmanager
def inject_replica_loss(replica, step):
    """Context-manager form of :func:`arm_replica_loss`; disarms on
    exit. Yields the state dict so tests can assert
    ``state["fired"] == 1``."""
    state = arm_replica_loss(replica, step)
    try:
        yield state
    finally:
        disarm_replica_loss()


def replica_loss_for(fleet_step):
    """The replica index to kill at fleet step ``fleet_step``, or None.

    Polled by ``serving.fleet.ServeFleet.step`` every tick — the
    replica-loss sibling of :func:`poison_slot_for`, keyed on the
    fleet's lifetime step counter. One-shot: a matching call marks the
    arming fired so the respawned replica comes up clean. Env arming
    (``APEX_TPU_FAULT_PLAN="replica_loss@N:R"``) is read lazily on
    first consult and follows the same one-shot contract."""
    global _replica_loss_state
    if _replica_loss_state is None and fault_plan().get("replica_loss"):
        e = fault_plan().get("replica_loss")
        _replica_loss_state = {"replica": int(e["arg"] or 0),
                               "step": e["step"], "fired": 0}
    st = _replica_loss_state
    if not st or st["fired"] or int(fleet_step) != st["step"]:
        return None
    st["fired"] += 1
    return st["replica"]


_kv_corrupt_state = None   # {"replica", "step", "fired"}


def arm_kv_corrupt(replica, step):
    """Arm a one-shot KV-payload corruption: at fleet step ``step``
    (the fleet's lifetime step counter, 0-based), the migration
    payload extracted FROM donor replica ``replica`` gets one byte
    flipped in flight — the checksum-fallback drill. The survivor must
    detect the mismatch, count a loud fallback, and re-prefill from
    tokens with the stream still completing. Returns the armed-state
    dict (``"fired"`` counts firings). Overwrites any previous
    arming."""
    global _kv_corrupt_state
    _kv_corrupt_state = {"replica": int(replica), "step": int(step),
                         "fired": 0}
    return _kv_corrupt_state


def disarm_kv_corrupt():
    global _kv_corrupt_state
    _kv_corrupt_state = None


@contextlib.contextmanager
def inject_kv_corrupt(replica, step):
    """Context-manager form of :func:`arm_kv_corrupt`; disarms on
    exit. Yields the state dict so tests can assert
    ``state["fired"] == 1``."""
    state = arm_kv_corrupt(replica, step)
    try:
        yield state
    finally:
        disarm_kv_corrupt()


def kv_corrupt_for(fleet_step):
    """The donor replica index whose extracted KV payload is corrupted
    at fleet step ``fleet_step``, or None.

    Polled by ``serving.fleet.ServeFleet`` at KV-state capture time —
    the payload-integrity sibling of :func:`replica_loss_for`, keyed
    on the same lifetime step counter (arm both at the same step to
    corrupt the handoff of the replica being killed). One-shot: a
    matching call marks the arming fired. Env arming
    (``APEX_TPU_FAULT_PLAN="kv_corrupt@N:R"``) is read lazily on first
    consult and follows the same one-shot contract."""
    global _kv_corrupt_state
    if _kv_corrupt_state is None and fault_plan().get("kv_corrupt"):
        e = fault_plan().get("kv_corrupt")
        _kv_corrupt_state = {"replica": int(e["arg"] or 0),
                             "step": e["step"], "fired": 0}
    st = _kv_corrupt_state
    if not st or st["fired"] or int(fleet_step) != st["step"]:
        return None
    st["fired"] += 1
    return st["replica"]


def request_storm(n_requests, *, at_tick=0.0, seed=0,
                  prompt_lens=(4, 8, 12), max_new=(4, 8),
                  vocab_size=256, rid_base=10_000):
    """A burst trace: ``n_requests`` all arriving at ``at_tick`` — the
    admission-control drill (``synthetic_trace``'s Poisson arrivals
    never pile up fast enough to exercise shedding on a small trace).
    Deterministic per seed; rids start at ``rid_base`` so a storm can
    ride on top of a regular trace without colliding."""
    from apex_tpu_torch.serving.scheduler import Request

    rs = np.random.RandomState(seed)
    out = []
    for i in range(int(n_requests)):
        plen = int(rs.choice(prompt_lens))
        out.append(Request(
            rid=rid_base + i,
            prompt=rs.randint(0, vocab_size, size=plen).astype("int32"),
            max_new_tokens=int(rs.choice(max_new)),
            arrival=float(at_tick)))
    return out


def simulate_preemption(sig=signal.SIGTERM):
    """Deliver a real signal to this process (default SIGTERM — what a
    cluster's preemption sends). Pair with an installed
    :class:`~apex_tpu_torch.resilience.preemption.PreemptionGuard`, or the
    default handler will kill the process, which is the point of the
    drill."""
    signal.raise_signal(sig)
