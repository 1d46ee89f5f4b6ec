"""apex_tpu_torch.telemetry against apex_tpu.telemetry on the CPU.

- The registry: the same call sequence lands the same counters, gauges,
  histogram summaries and events (timestamps and pids aside) in both
  packages, the JSONL sink included, and nothing while disabled.
- Spans: the same nesting of ``span``, ``emit_span`` and ``emit_flow``
  gives the same events and the same parent/child tree (ids are random,
  so the tree is compared by shape).
- The JAX package's readers, ``tools/telemetry_report.py`` and
  ``tools/trace_export.py``, ``tools/numerics_report.py`` and
  ``tools/memory_report.py``, render this package's sink (run as
  subprocesses, as a user runs them).
- ``comm.record_collective``, ``compile_watch`` (signature-keyed compiles
  and ``assert_no_recompiles``), ``memory`` (the OOM post-mortem with a
  labeled census, the preflight's judgement), ``cost`` (FlopCounterMode
  plus the kernels' own counts), and the not-yet-ported ``monitor`` and
  ``attribution`` names, which raise naming their ROADMAP items.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from apex_tpu import telemetry as jtel
from apex_tpu.telemetry import comm as jcomm
from apex_tpu.telemetry import compile_watch as jcw
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.kernels import registry as kreg
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.telemetry import comm as tcomm
from apex_tpu_torch.telemetry import compile_watch as tcw
from apex_tpu_torch.telemetry import cost, memory
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("t", "ts", "pid", "epoch_unix")


def _plain(events, drop=STAMPS):
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _record(pkg):
    """The same call sequence on a fresh enabled registry of ``pkg``;
    returns (events, snapshot without its stamp)."""
    reg = pkg.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    with pkg.use_registry(reg):
        reg.counter("c").inc()
        reg.counter("c").inc(2.5)
        reg.gauge("g").set(3)
        for v in (4.0, 1.0, 9.0, 2.0):
            reg.histogram("h").observe(v)
        reg.event("custom", "thing", a=1, b=[1, 2])
        reg.flush()
        snap = reg.snapshot()
    snap.pop("ts")
    return events, snap


def test_registry_matches_jax_for_the_same_calls():
    ev_j, snap_j = _record(jtel)
    ev_t, snap_t = _record(ttel)
    assert snap_t == snap_j
    for e in ev_j + ev_t:
        if e["kind"] == "summary":
            e.pop("ts")
    assert _plain(ev_t) == _plain(ev_j)
    assert snap_t["histograms"]["h"]["p50"] == 3.0


def test_registry_disabled_by_default_and_sink(monkeypatch, tmp_path):
    monkeypatch.delenv("APEX_TPU_TELEMETRY_DIR", raising=False)
    reg = ttel.MetricsRegistry()
    assert not reg.enabled
    reg.counter("x").inc()
    reg.event("span", "x")
    assert reg.snapshot()["counters"] == {}
    sink = ttel.MetricsRegistry(jsonl_dir=str(tmp_path))
    sink.counter("x").inc()
    sink.event("custom", "y", v=1)
    lines = [json.loads(l) for l in
             (tmp_path / "telemetry-rank0.jsonl").read_text().splitlines()]
    assert [l["kind"] for l in lines] == ["trace_epoch", "custom"]
    assert lines[0]["rank"] == 0 and "epoch_unix" in lines[0]


def _span_tree(pkg):
    reg = pkg.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    with pkg.use_registry(reg):
        with pkg.trace_context(baggage={"tier": "batch"}) as ctx:
            with pkg.span("outer", step=1):
                with pkg.span("inner"):
                    pass
                pkg.emit_span("manual", 0.0, 1.0, parent_id="p", rid=3)
            pkg.emit_flow("handoff", "f1", "out", trace_id=ctx.trace_id)
    ids = {}
    out = []
    for e in events:
        rec = {k: v for k, v in e.items()
               if k not in STAMPS + ("duration_s", "trace_id", "span_id",
                                     "parent_id")}
        for key in ("span_id", "parent_id"):
            v = e.get(key)
            if v:
                rec[key] = ids.setdefault(v, len(ids))
        out.append(rec)
    return out, len({e.get("trace_id") for e in events if e.get("trace_id")})


def test_span_events_and_tree_match_jax():
    got, traces_t = _span_tree(ttel)
    want, traces_j = _span_tree(jtel)
    assert got == want
    assert traces_t == traces_j == 1


def test_fenced_span_refuses_inside_a_capture(monkeypatch):
    from apex_tpu_torch.telemetry import trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="graph"):
        trace.device_sync()


def test_profiler_pair_gated_by_env(monkeypatch, tmp_path):
    monkeypatch.delenv("APEX_TPU_PROFILE_DIR", raising=False)
    assert ttel.start_profiler_trace() is False
    assert ttel.stop_profiler_trace() is False
    assert ttel.start_profiler_trace(str(tmp_path)) is True
    torch.ones(4).sum()
    assert ttel.stop_profiler_trace() is True
    assert any(tmp_path.iterdir())


def _comm(pkg_comm, reg_pkg, dtypes):
    reg = reg_pkg.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    out = []
    for op, dt, bits in (("psum", dtypes[0], None), ("pmax", dtypes[1], None),
                         ("psum_scatter", dtypes[2], 4),
                         ("all_gather", dtypes[1], None)):
        out.append(pkg_comm.record_collective(
            op, elements=1000, dtype=dt, axis_name="dp", world=4,
            mode="int8", bits=bits, registry=reg))
    return out, _plain(events), reg.snapshot()["counters"]


def test_record_collective_matches_jax():
    want = _comm(jcomm, jtel, (jnp.float32, jnp.bfloat16, jnp.int8))
    got = _comm(tcomm, ttel, (torch.float32, torch.bfloat16, torch.int8))
    assert got == want
    # disabled: nothing recorded, no wire bytes reported
    assert tcomm.record_collective("psum", elements=8, dtype=torch.float32,
                                   registry=ttel.MetricsRegistry()) == 0.0


def test_abstract_signature_and_recompile_diff():
    w = tcw.CompileWatcher(enabled=True,
                           registry=ttel.MetricsRegistry(enabled=True))
    step = w.watch(lambda x, n=1: x * n, name="step")
    step(torch.zeros(2, 3))
    step(torch.ones(2, 3))                 # same signature: no compile
    assert w.compile_count("step") == 1
    step(torch.zeros(4, 3))                # a new shape: a recompile
    assert w.recompile_count() == 1
    change = w.last_changes()["step"]
    assert change == [{"arg": "args/0", "old": "float32[2, 3]@cpu",
                       "new": "float32[4, 3]@cpu"}]
    # JAX's diff of the same descriptors names the same argument
    assert jcw.diff_signatures({"args/0": "a"}, {"args/0": "b"}) == \
        tcw.diff_signatures({"args/0": "a"}, {"args/0": "b"})
    with tcw.assert_no_recompiles(w):
        step(torch.ones(4, 3))
    with pytest.raises(tcw.RecompileError, match="args/0"):
        with tcw.assert_no_recompiles(w):
            step(torch.zeros(5, 3))
    # a CUDA-graph capture or an nvcc build counts even unwatched
    with pytest.raises(tcw.RecompileError):
        with tcw.assert_no_recompiles(tcw.CompileWatcher(enabled=False)):
            tcw.note_compile("nvcc", "stats.cu", 1.0)
    off = tcw.CompileWatcher(enabled=False)
    fn = lambda x: x  # noqa: E731
    assert off.watch(fn) is fn


def test_oom_guard_writes_labeled_postmortem(tmp_path):
    masters = [torch.zeros(64, 8), torch.zeros(32)]
    moments = {"m": torch.zeros(100), "v": torch.zeros(100)}
    reg = ttel.MetricsRegistry(enabled=True)
    with pytest.raises(memory.HBMExhaustedError) as info:
        with memory.oom_guard(str(tmp_path), registry=reg,
                              labels={"masters": masters,
                                      "moments": moments}):
            faults.inject_alloc_failure(3, alloc_step=3)
    assert isinstance(info.value.__cause__, faults.SyntheticResourceExhausted)
    rec = json.loads((tmp_path / "memory-postmortem-rank0.json").read_text())
    labels = {g["label"] for g in rec["census"]["groups"]}
    assert {"masters", "moments"} <= labels or rec["census"]["dropped_groups"]
    census = memory.live_buffer_census(
        top_k=0, labels={"masters": masters, "moments": moments},
        device_type="cpu")
    rows = [g for g in census["groups"] if g["label"] != "<anon>"]
    assert sorted((g["label"], tuple(g["shape"]), g["bytes"])
                  for g in rows) == [
        ("masters", (32,), 128), ("masters", (64, 8), 2048),
        ("moments", (100,), 800)]
    assert memory.is_oom_error(torch.cuda.OutOfMemoryError("CUDA oom"))
    assert not memory.is_oom_error(ValueError("x"))
    # other errors pass through untouched
    with pytest.raises(ValueError):
        with memory.oom_guard(str(tmp_path)):
            raise ValueError("not an OOM")


def test_preflight_judgement_and_cpu_measure():
    assert memory.step_memory(lambda: None) is None  # no card: no measure
    assert memory.preflight(lambda: None) is None
    rep = memory.make_report("serve/decode", peak_bytes=1000,
                             capacity_bytes=2000)
    assert rep["headroom_frac"] == 0.5
    assert memory.judge(rep)["over_budget"] is False
    with pytest.warns(UserWarning, match="exceeds"):
        assert memory.judge(rep, capacity_bytes=999)["over_budget"]
    with pytest.raises(memory.MemoryBudgetError, match="exceeds"):
        memory.judge(rep, strict=True, capacity_bytes=999)


def test_memory_report_lands_gauges_event_and_trend():
    """A recorded report sets JAX's two gauges, lands its ``memory``
    event and joins the headroom trend; ``reset_trend`` empties it."""
    memory.reset_trend()
    rep = memory.make_report("train/step", peak_bytes=600,
                             capacity_bytes=1000)
    reg = ttel.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    memory.record_report(rep, registry=reg)
    gauges = reg.snapshot()["gauges"]
    assert gauges["memory/peak_hbm_bytes"] == 600
    assert gauges["memory/hbm_headroom"] == pytest.approx(0.4)
    assert [(e["kind"], e["name"], e["step"]) for e in events] == [
        ("memory", "step_memory", "train/step")]
    assert [(t["peak_bytes"], t["headroom_frac"])
            for t in memory.headroom_trend()] == [(600, rep["headroom_frac"])]
    memory.reset_trend()
    assert memory.headroom_trend() == []


def test_step_cost_adds_the_kernels_own_counts():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    name = kreg.register("test_kernel_for_cost")

    def step():
        kreg.count(name, flops=1000.0, bytes=64.0)
        return a @ b

    c = cost.step_cost(step)
    assert c["torch_flops"] == 2 * 16 * 32 * 8
    assert c["kernel_flops"] == 1000.0 and c["kernel_bytes"] == 64.0
    assert c["flops"] == 2 * 16 * 32 * 8 + 1000.0
    assert cost.peak_table("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    reg = ttel.MetricsRegistry(enabled=True)
    util = cost.record_step_cost(c, 0.5, registry=reg,
                                 name="NVIDIA H100 80GB HBM3")
    assert util["mfu"] == pytest.approx(c["flops"] / 0.5 / 989e12)
    assert reg.snapshot()["gauges"]["mfu"] == util["mfu"]


def test_not_ported_names_raise_their_items():
    with pytest.raises(NotImplementedError, match=r"5\(c\)"):
        ttel.Monitor()
    with pytest.raises(NotImplementedError, match=r"5\(c\)"):
        ttel.render_openmetrics({})
    with pytest.raises(NotImplementedError, match="item 6"):
        ttel.PipelineAttributor()


def _tool(name, *args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", name), *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT)


def test_the_tools_render_this_packages_sink(tmp_path):
    """The JAX package's readers run unchanged over a sink this package
    wrote: spans, collectives, amp, guard, a numerics and a memory
    post-mortem."""
    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.resilience import check_guard, init_guard_state
    from apex_tpu_torch.telemetry import numerics

    reg = ttel.MetricsRegistry(jsonl_dir=str(tmp_path))
    with ttel.use_registry(reg):
        with ttel.span("train/step", step=0):
            with ttel.span("ddp/sync"):
                tcomm.record_collective("psum", elements=1000,
                                        dtype=torch.float32, world=2)
        sc = LossScaler("dynamic", device="cpu")
        sc.update(sc._state, torch.ones(1))
        rec = ttel.FlightRecorder(4, 1)
        grads = {"a": torch.tensor([1.0, float("nan")]),
                 "b": torch.ones(3)}
        state = rec.init_state(grads)
        rec.record(state, 0, numerics.tree_stats(grads, 1))
        gst = init_guard_state()
        gst = gst._replace(consecutive_skips=torch.tensor(1, dtype=torch.int32),
                           total_skips=torch.tensor(1, dtype=torch.int32),
                           last_skipped=torch.tensor(1, dtype=torch.int32))
        check_guard(gst, recorder=rec, recorder_state=state,
                    postmortem_dir=str(tmp_path))
        with pytest.raises(memory.HBMExhaustedError):
            with memory.oom_guard(str(tmp_path)):
                faults.inject_alloc_failure(0, alloc_step=0)
        reg.flush()
    reg.disable()
    report = _tool("telemetry_report.py", str(tmp_path))
    assert report.returncode == 0, report.stderr
    assert "ddp/sync" in report.stdout
    out = tmp_path / "trace.json"
    exported = _tool("trace_export.py", str(tmp_path), "-o", str(out))
    assert exported.returncode == 0, exported.stderr
    names = {e.get("name") for e in json.loads(out.read_text())[
        "traceEvents"]}
    assert {"train/step", "ddp/sync"} <= names
    num = _tool("numerics_report.py", str(tmp_path))
    assert num.returncode == 0 and "a" in num.stdout, num.stderr
    mem = _tool("memory_report.py", str(tmp_path))
    assert mem.returncode == 0, mem.stderr
