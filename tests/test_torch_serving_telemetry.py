"""The serving engine's telemetry and resilience (apex_tpu_torch.serving
with apex_tpu_torch.telemetry/resilience) against the JAX engine's on
the CPU, on test_torch_serving.py's small model and trace.

- With an enabled registry, the same trace served by both engines lands
  the same ``serve/*`` traffic counters and histogram counts, the same
  ``request_done`` events (rid, tokens, finish reason), and for every
  request a ``trace_id`` with the same span names (``serve/request``,
  ``serve/queued``, ``serve/prefill``, ``serve/decode``,
  ``serve/evict``) parented under its root; the engine's
  ``engine_start`` event and ``serve/kv_cache_bytes`` gauge are JAX's
  (the compile count aside: the CPU engine captures no graphs).
- Faults through ``resilience.faults``, as the JAX engine takes them: a
  transient decode failure retried once (the streams unchanged), a
  poisoned slot evicted as ``poisoned``.
- ``preflight_strict`` under the measured need refuses the engine.
- A ``PreemptionGuard`` signal mid-traffic drains the scheduler:
  ``extract_unfinished`` hands back the queued requests, and the
  in-flight ones finish inside the drain.
"""

import functools
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import telemetry as jtel
from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc  # noqa: F401  (registers its gate)
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.parallel import compression as jax_comp
from apex_tpu.serving import ServeConfig as JaxServeConfig
from apex_tpu.serving import ServeEngine as JaxServeEngine
from apex_tpu.serving import synthetic_trace as jax_synthetic_trace
from apex_tpu.transformer import parallel_state
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.models import GPTModel, TransformerConfig, from_jax_params
from apex_tpu_torch.resilience import PreemptionGuard, faults
from apex_tpu_torch.serving import (
    RobustConfig,
    Scheduler,
    ServeConfig,
    ServeEngine,
    synthetic_trace,
)
from apex_tpu_torch.telemetry.memory import MemoryBudgetError
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(hidden_size=128, num_layers=2, num_attention_heads=4,
          vocab_size=512, max_position_embeddings=128)
SERVE = dict(batch_buckets=(2, 4), prefill_buckets=(32,), num_slots=4)
TRACE = dict(seed=1, mean_interarrival=1.0, prompt_lens=(4, 9, 20, 30),
             max_new=(5, 9, 14), vocab_size=512)
TRAFFIC = ("serve/requests_completed", "serve/tokens_generated",
           "serve/requests_admitted", "serve/decode_steps")
SPANS = ["serve/decode", "serve/evict", "serve/prefill", "serve/queued",
         "serve/request"]


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc"])
    jax_gqa.force_interpret(True)
    jax_comp.force_interpret(True)
    yield
    jax_comp.force_interpret(False)
    jax_gqa.force_interpret(False)
    reg.force_interpret(False, ["fused_cc"])
    faults.disarm_slot_nan()
    faults.disarm_decode_failure()


@functools.lru_cache(maxsize=None)
def _models():
    model_j = JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.float32,
                                    use_flash_attention=False), decode=True)
    params = JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**KW, compute_dtype=torch.float32)
    model_t = GPTModel(cfg, device="cpu")
    model_t.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    return model_j, params, model_t


def _digest(events, snap):
    done = sorted((e["rid"], e["tokens"], e["finish_reason"])
                  for e in events if e["name"] == "request_done")
    spans = {}
    roots = {}
    for e in events:
        if e["kind"] == "span" and e["name"] in SPANS:
            spans.setdefault(e.get("rid"), []).append(e["name"])
            if e["name"] == "serve/request":
                roots[e["rid"]] = (e["span_id"], e["trace_id"])
    for e in events:
        if e["kind"] == "span" and e["name"] in SPANS[:4]:
            assert e["parent_id"] == roots[e["rid"]][0]
            assert e["trace_id"] == roots[e["rid"]][1]
    start = [{k: v for k, v in e.items()
              if k not in ("t", "ts", "aot_compile_seconds",
                           "compile_count", "engine")}
             for e in events if e["name"] == "engine_start"]
    return {"done": done,
            "spans": {rid: sorted(v) for rid, v in spans.items()},
            "traced": len(roots),
            "counters": {k: snap["counters"].get(k) for k in TRAFFIC},
            "ttft": snap["histograms"]["serve/ttft"]["count"],
            "tok": snap["histograms"]["serve/tok_latency"]["count"],
            "kv": snap["gauges"]["serve/kv_cache_bytes"],
            "start": start}


@functools.lru_cache(maxsize=None)
def _jax_digest():
    model_j, params, _ = _models()
    reg = jtel.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    with jtel.use_registry(reg):
        eng = JaxServeEngine(model_j, params, JaxServeConfig(**SERVE),
                             registry=reg)
        eng.serve(jax_synthetic_trace(8, **TRACE))
    return _digest(events, reg.snapshot())


def test_serve_telemetry_matches_jax():
    reg = ttel.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    trace = synthetic_trace(8, **TRACE)
    assert all(r.trace_id is None for r in trace)
    with ttel.use_registry(reg):
        eng = ServeEngine(_models()[2], ServeConfig(**SERVE), registry=reg)
        done, _ = eng.serve(trace)
    got = _digest(events, reg.snapshot())
    want = _jax_digest()
    assert got == want
    assert got["traced"] == len(done) == 8
    # allocated at submit, and kept by dataclasses.replace
    assert all(r.trace_id for r in trace)
    import dataclasses

    assert dataclasses.replace(trace[0], arrival=5.0).trace_id == \
        trace[0].trace_id


def test_decode_failure_retried_and_poisoned_slot_evicted():
    eng = ServeEngine(_models()[2], ServeConfig(**SERVE))
    clean, _ = eng.serve(synthetic_trace(8, **TRACE))
    eng = ServeEngine(_models()[2], ServeConfig(**SERVE))
    with faults.inject_decode_failure(3, transient=True) as fail:
        done, stats = eng.serve(synthetic_trace(8, **TRACE),
                                robust=RobustConfig(retry_backoff_s=0.0))
    assert fail["fired"] == 1 and stats["decode_retries"] == 1
    assert {c.rid: c.tokens.tolist() for c in done} == \
        {c.rid: c.tokens.tolist() for c in clean}
    eng = ServeEngine(_models()[2], ServeConfig(**SERVE))
    with faults.inject_slot_nan(1, 2) as poisoned:
        done, _ = eng.serve(synthetic_trace(8, **TRACE))
    assert poisoned["fired"] == 1
    reasons = [c.finish_reason for c in done]
    assert reasons.count("poisoned") == 1 and len(done) == 8


def test_strict_preflight_refuses_under_the_measured_need(monkeypatch):
    eng = ServeEngine(_models()[2], ServeConfig(**SERVE))
    need = eng.memory_report["peak_bytes"]
    assert need == eng.weight_bytes() + eng.kv_cache_bytes()
    # the capacity through the JAX package's override, in decimal GB
    monkeypatch.setenv("APEX_TPU_HBM_GB", str((need - 1000) / 1e9))
    with pytest.raises(MemoryBudgetError):
        ServeEngine(_models()[2], ServeConfig(**SERVE,
                                              preflight_strict=True))
    with pytest.warns(UserWarning, match="exceeds"):
        ServeEngine(_models()[2], ServeConfig(**SERVE))


def test_sigterm_mid_traffic_drains_and_extracts():
    eng = ServeEngine(_models()[2], ServeConfig(**SERVE))
    reg = ttel.MetricsRegistry(enabled=True)
    events = []
    reg.add_event_tap(events.append)
    prev = signal.getsignal(signal.SIGTERM)
    with ttel.use_registry(reg), PreemptionGuard() as guard:
        sched = Scheduler(eng, guard=guard)
        for r in synthetic_trace(8, **TRACE):
            sched.submit(r)
        for _ in range(3):
            sched.step()
        assert sched.active and not sched.draining
        faults.simulate_preemption()
        sched.step()
        assert sched.draining and sched._drain_reason == "preempted"
        moved = sched.extract_unfinished(reason="preempted",
                                         which="pending")
        done = sched.run()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert moved and all(m["where"] == "pending" for m in moved)
    assert {c.finish_reason for c in done} <= {"length", "eos", "drained"}
    assert len(done) + len(moved) == 8
    assert sched.drain_report.reason == "preempted"
    names = [e["name"] for e in events if e["kind"] == "serve"]
    assert "drain_start" in names and "drain_report" in names
    assert names.count("extracted") == len(moved)
