"""apex_tpu_torch.serving (ServeEngine, Scheduler, KVCacheSpec,
synthetic_trace) against apex_tpu.serving on the CPU.

A tiny GPT (2 layers, hidden 128, 4 heads, vocab 512, 128 positions;
the JAX package's default shape otherwise: learned positions, gelu,
LayerNorm) is initialised in JAX and its weights go to the port through
``from_jax_params``. Both engines run in fp32 compute, as the JAX
package's own serving tests do, so that greedy streams are comparable
token for token; the JAX side runs its decode, window and quantize
kernels in Pallas interpret mode. The JAX engines keep short bucket
ladders: each bucket is an ahead-of-time compile.

Tolerances: token streams and store bytes are compared exactly; the
int8 round trip is held to the documented per-block bound, half a grid
step (absmax / 254) per lane.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc  # noqa: F401  (registers its gate)
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.parallel import compression as jax_comp
from apex_tpu.serving import KVCacheSpec as JaxKVCacheSpec
from apex_tpu.serving import ServeConfig as JaxServeConfig
from apex_tpu.serving import ServeEngine as JaxServeEngine
from apex_tpu.serving import scheduler as jax_serving
from apex_tpu.serving import synthetic_trace as jax_synthetic_trace
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    from_jax_params,
    generate,
    init_cache,
    prefill,
)
from apex_tpu_torch.serving import (
    KVCacheSpec,
    NonFiniteError,
    Request,
    RobustConfig,
    Scheduler,
    ServeConfig,
    ServeEngine,
    payload_checksum,
    store_lengths,
    synthetic_trace,
)
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(hidden_size=128, num_layers=2, num_attention_heads=4,
          vocab_size=512, max_position_embeddings=128)
SERVE = dict(batch_buckets=(2, 4), prefill_buckets=(32,), num_slots=4)


def _trace(n=8, seed=1):
    return synthetic_trace(n, seed=seed, mean_interarrival=1.0,
                           prompt_lens=(4, 9, 20, 30), max_new=(5, 9, 14),
                           vocab_size=512)


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
    # an engine's poison_slot arms the process-wide fault injector: never
    # leave an arming for the next test's engine
    from apex_tpu_torch.resilience import faults

    faults.disarm_slot_nan()
    faults.disarm_decode_failure()


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX decode model, its params, the port's model with the same
    weights), fp32 compute; built once (nothing mutates them)."""
    model_j = JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.float32,
                                    use_flash_attention=False), decode=True)
    params = JaxGPTModel(JaxConfig(**KW, compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**KW, compute_dtype=torch.float32)
    model_t = GPTModel(cfg, device="cpu")
    model_t.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    return model_j, params, model_t


def _streams(completed):
    return {c.rid: c.tokens.tolist() for c in completed}


@functools.lru_cache(maxsize=None)
def _jax_streams(mode):
    model_j, params, _ = _models()
    eng = JaxServeEngine(model_j, params, JaxServeConfig(
        **SERVE, cache_mode=mode))
    done, stats = eng.serve(jax_synthetic_trace(
        8, seed=1, mean_interarrival=1.0, prompt_lens=(4, 9, 20, 30),
        max_new=(5, 9, 14), vocab_size=512))
    return _streams(done), stats


def _engine(mode="bf16", **kw):
    return ServeEngine(_models()[2], ServeConfig(**{**SERVE, **kw},
                                                 cache_mode=mode))


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def test_synthetic_trace_is_byte_identical_to_jax_and_deterministic():
    for kw in ({}, dict(shared_prefix_len=7, shared_frac=0.5)):
        a = synthetic_trace(12, seed=3, **kw)
        b = synthetic_trace(12, seed=3, **kw)
        j = jax_synthetic_trace(12, seed=3, **kw)
        for x, y, z in zip(a, b, j):
            assert x.prompt.tobytes() == y.prompt.tobytes() \
                == z.prompt.tobytes()
            assert (x.rid, x.max_new_tokens, x.arrival) == \
                (z.rid, z.max_new_tokens, z.arrival) == \
                (y.rid, y.max_new_tokens, y.arrival)
    assert [r.prompt.tolist() for r in synthetic_trace(4, seed=4)] != \
        [r.prompt.tolist() for r in synthetic_trace(4, seed=5)]


# ---------------------------------------------------------------------------
# KVCacheSpec: bytes, int8 bound, no drift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("groups,block", [(None, 256), (2, 256), (4, 48)])
def test_kv_cache_bytes_equal_jax(dtype, mode, groups, block):
    kw = dict(KW, num_query_groups=groups)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    spec_j = JaxKVCacheSpec(JaxGPTModel(JaxConfig(**kw, compute_dtype=jdt),
                                        decode=True), 8, mode=mode,
                            block_size=block)
    spec_t = KVCacheSpec(GPTModel(TransformerConfig(**kw, compute_dtype=tdt),
                                  device="cpu"), 8, mode=mode,
                         block_size=block)
    assert spec_t.total_bytes() == spec_j.total_bytes()
    assert spec_t.bytes_per_slot() == spec_j.bytes_per_slot()
    assert spec_t.total_bytes(kv_itemsize=4) == spec_j.total_bytes(
        kv_itemsize=4)
    assert spec_t.cache_dtype_name() == spec_j.cache_dtype_name()


def test_int8_store_is_smaller_and_its_allocation_matches():
    model = _models()[2]
    bf16, int8 = (KVCacheSpec(model, 4, mode=m) for m in ("bf16", "int8"))
    assert int8.total_bytes() < bf16.total_bytes()
    assert bf16.total_bytes(kv_itemsize=4) / int8.total_bytes() >= 3.5
    for spec in (bf16, int8):
        store = spec.allocate()
        allocated = sum(
            t.numel() * t.element_size() for name in ("keys", "values")
            for leaf in store[name]
            for t in (leaf.values() if isinstance(leaf, dict) else [leaf]))
        # the store holds one fill level a slot where JAX holds one a layer
        assert allocated + 4 * spec.num_layers * 4 == spec.total_bytes()
        assert tuple(store_lengths(store).shape) == (4,)
    with pytest.raises(ValueError, match="mode"):
        KVCacheSpec(model, 2, mode="fp8")


def _filled_cache(spec, b, seed, scale=0.5):
    """A model-ready cache of b rows with random K/V and levels."""
    rs = np.random.RandomState(seed)
    cache = init_cache(spec.model, b)
    for t in cache.keys + cache.values:
        t.copy_(torch.from_numpy(rs.randn(*t.shape).astype(np.float32)
                                 * scale))
    cache.set_lengths(torch.from_numpy(rs.randint(1, spec.max_len - 8,
                                                  (b,)).astype(np.int32)))
    return cache


def test_int8_round_trip_within_bound():
    spec = KVCacheSpec(_models()[2], 4, mode="int8")
    cache = _filled_cache(spec, 3, 0)
    back = spec.materialize_rows(spec.quantize_rows(cache))
    for a, b in zip(cache.keys + cache.values, back.keys + back.values):
        flat = a.reshape(a.shape[0], a.shape[1], -1)  # one block a position
        bound = flat.abs().amax(-1) / 254.0
        err = (b - a).reshape(flat.shape).abs().amax(-1)
        assert (err <= bound + 1e-7).all()
        assert spec.quantization_bound(1.0) == 1.0 / 254.0


def test_store_quantization_matches_jax_bitwise():
    """The same K/V quantize to the same codes and scales in both
    stores (the JAX store puts the slot axis first)."""
    model_j, _, model_t = _models()
    spec_t = KVCacheSpec(model_t, 2, mode="int8")
    spec_j = JaxKVCacheSpec(model_j, 2, mode="int8")
    cache = _filled_cache(spec_t, 2, 1)
    rows_t = spec_t.quantize_rows(cache)
    raw = {"transformer": {f"layer_{i}": {"self_attention": {
        "cached_key": jnp.asarray(cache.keys[i].permute(1, 0, 2, 3)
                                  .numpy())[:, :, None],
        "cached_value": jnp.asarray(cache.values[i].permute(1, 0, 2, 3)
                                    .numpy())[:, :, None],
        "cache_index": jnp.zeros((2,), jnp.int32)}}
        for i in range(spec_t.num_layers)}}
    rows_j = spec_j.quantize_rows(raw)
    for i in range(spec_t.num_layers):
        for name, key in (("keys", "cached_key"), ("values", "cached_value")):
            got = rows_t[name][i]
            want = rows_j["transformer"][f"layer_{i}"]["self_attention"][key]
            np.testing.assert_array_equal(got["q"].permute(1, 0, 2, 3),
                                          np.asarray(want["q"]))
            np.testing.assert_array_equal(got["scale"].permute(1, 0, 2, 3),
                                          np.asarray(want["scale"]))


@pytest.mark.parametrize("span", [1, 4])
def test_updates_are_drift_free(span):
    """An append requantizes only its own positions: every other block's
    codes and scale stay bit-identical (update_rows_at is span 1)."""
    spec = KVCacheSpec(_models()[2], 4, mode="int8")
    cache = _filled_cache(spec, 2, 2)
    rows = spec.quantize_rows(cache)
    old = {name: [{k: v.clone() for k, v in leaf.items()}
                  for leaf in rows[name]] for name in ("keys", "values")}
    start = torch.tensor([3, 120], dtype=torch.int32)  # 120 + 4 > 128 - 4
    rs = np.random.RandomState(3)
    for t in cache.keys + cache.values:  # fresh K/V everywhere
        t.add_(torch.from_numpy(rs.randn(*t.shape).astype(np.float32)))
    if span == 1:
        spec.update_rows_at(rows, cache, start)
    else:
        spec.update_rows_span(rows, cache, start, span)
    fresh = spec.quantize_rows(cache)
    T = spec.max_len
    for name in ("keys", "values"):
        for new, before, ref in zip(rows[name], old[name], fresh[name]):
            for row in range(2):
                lo = int(start[row])
                inside = [t for t in range(lo, min(lo + span, T))]
                outside = [t for t in range(T) if t not in inside]
                for key in ("q", "scale"):
                    assert torch.equal(new[key][outside, row],
                                       before[key][outside, row])
                    assert torch.equal(new[key][inside, row],
                                       ref[key][inside, row])
                assert not torch.equal(new["q"][inside, row],
                                       before["q"][inside, row])
    assert rows["lengths"] is cache.lengths


def test_payload_checksum_folds_and_detects_a_flip():
    spec = KVCacheSpec(_models()[2], 2, mode="int8")
    rows = spec.quantize_rows(_filled_cache(spec, 1, 4))
    crc = payload_checksum(rows)
    assert crc == payload_checksum(rows)
    assert payload_checksum([rows, rows]) == payload_checksum(rows, crc)
    rows["keys"][0]["q"][5, 0, 0, 0] += 1
    assert payload_checksum(rows) != crc
    # numpy leaves checksum as the JAX package's does
    arr = np.arange(6, dtype=np.int32)
    from apex_tpu.serving.kv_cache import payload_checksum as jax_crc
    assert payload_checksum({"a": arr, "b": [arr]}) == jax_crc(
        {"a": arr, "b": [arr]})


# ---------------------------------------------------------------------------
# the engine against JAX's, against generate, and its guard rails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_engine_tokens_equal_jax_engine(mode):
    want, want_stats = _jax_streams(mode)
    done, stats = _engine(mode).serve(_trace())
    assert len(done) == 8
    assert all(c.finish_reason == "length" for c in done)
    assert _streams(done) == want
    for key in ("decode_steps", "prefill_calls", "tokens_generated",
                "requests_ok"):
        assert stats[key] == want_stats[key], key


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_pad_slot_levels_past_max_positions_match_jax(mode):
    """A free slot that pads a bucket advances its level on every decode
    call, as in JAX, until it is admitted again: here slot 1 ends
    request 1 at level 20 and pads request 0's bucket for ~20 more
    steps, past the 32 learned positions. The position lookup clamps as
    JAX's gather does, and request 0's stream equals JAX's."""
    kw = {**KW, "max_position_embeddings": 32}
    model_j = JaxGPTModel(JaxConfig(**kw, compute_dtype=jnp.float32,
                                    use_flash_attention=False), decode=True)
    params = JaxGPTModel(JaxConfig(**kw, compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = TransformerConfig(**kw, compute_dtype=torch.float32)
    model_t = GPTModel(cfg, device="cpu")
    model_t.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params), cfg))
    serve = dict(batch_buckets=(2,), prefill_buckets=(16,), num_slots=2,
                 cache_mode=mode)
    rng = np.random.default_rng(5)
    reqs = [(0, rng.integers(0, 512, 4), 27), (1, rng.integers(0, 512, 14), 6)]
    jdone, _ = JaxServeEngine(model_j, params, JaxServeConfig(**serve)).serve(
        [jax_serving.Request(rid, p.astype(np.int32), n)
         for rid, p, n in reqs])
    eng = ServeEngine(model_t, ServeConfig(**serve))
    done, stats = eng.serve([Request(rid, p.astype(np.int32), n)
                             for rid, p, n in reqs])
    assert all(c.finish_reason == "length" for c in done)
    assert _streams(done) == _streams(jdone)
    assert stats["decode_steps"] == 26
    assert eng.slot_lengths()[1] > 32  # the pad slot ran past the table


def test_greedy_engine_equals_generate():
    model = _models()[2]
    done, _ = _engine("bf16").serve(_trace())
    for r in _trace():
        want = generate(model, torch.as_tensor(r.prompt)[None],
                        r.max_new_tokens)[0, len(r.prompt):]
        assert _streams(done)[r.rid] == want.tolist()


def test_padded_prefill_logits_and_other_slots_untouched():
    """A bucket's prefill rolls each row back to its true length and
    takes the first token there; slots outside the bucket keep their
    bytes, and a decode over one bucket leaves the others alone."""
    model = _models()[2]
    eng = _engine("int8")
    prompts = [np.arange(5) + 7, np.arange(17) + 3]
    first = eng.prefill([1, 3], prompts, pad_slot_ids=[0, 2])
    for p, tok in zip(prompts, first):
        cache = init_cache(model, 1)
        _, logits = prefill(model, cache, torch.as_tensor(p)[None],
                            torch.arange(len(p))[None])
        assert int(torch.argmax(logits[0])) == tok
    lengths = eng.slot_lengths()
    assert lengths[1] == 5 and lengths[3] == 17
    before = {k: [{n: t.clone() for n, t in leaf.items()}
                  for leaf in eng._store[k]] for k in ("keys", "values")}
    eng.decode([3], [int(first[1])], pad_slot_ids=[2])
    after = eng._store
    for name in ("keys", "values"):
        for b_leaf, a_leaf in zip(before[name], after[name]):
            for key in ("q", "scale"):
                assert torch.equal(a_leaf[key][:, [0, 1]],
                                   b_leaf[key][:, [0, 1]])
                assert not torch.equal(a_leaf[key][:, 3], b_leaf[key][:, 3])
    assert eng.slot_lengths()[3] == 18 and eng.slot_lengths()[1] == 5


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_poisoned_slot_is_quarantined(mode):
    """poison_slot makes one slot's logits NaN in one decode call: that
    request ends ``poisoned`` with its rows zeroed, the others keep the
    streams of a clean run."""
    clean, _ = _engine(mode).serve(_trace())
    eng = _engine(mode)
    eng.poison_slot(1, at_call=2)
    sched = Scheduler(eng)
    done = sched.run(_trace())
    reasons = {c.rid: c.finish_reason for c in done}
    assert sorted(reasons.values()).count("poisoned") == 1
    bad = next(rid for rid, r in reasons.items() if r == "poisoned")
    streams = _streams(done)
    for rid, toks in streams.items():
        if rid == bad:
            assert toks == _streams(clean)[rid][:len(toks)]
        else:
            assert toks == _streams(clean)[rid]
    assert sched.stats()["requests_quarantined"] == 1
    # the poisoned slot's rows were zeroed on the device
    eng2 = _engine(mode)
    first = eng2.prefill([0, 1], [np.arange(6), np.arange(9)])
    eng2.poison_slot(1)
    nxt, finite = eng2.decode([0, 1], first)
    assert finite.tolist() == [True, False] and nxt[1] == 0
    assert eng2.slot_lengths()[1] == 0
    for leaf in eng2._store["keys"]:
        t = leaf["q"] if isinstance(leaf, dict) else leaf
        assert not t[:, 1].any()


def test_decode_retries_and_fails_only_the_implicated_requests():
    """A transient failure of a decode call is retried (the streams stay
    those of a clean run); one that outlasts the retry budget fails only
    the requests of that call; anything else propagates."""
    clean, _ = _engine("bf16").serve(_trace())
    eng = _engine("bf16")
    real, calls = eng._decode_fn, []

    def flaky(*args):
        calls.append(len(calls))
        if len(calls) == 3:
            raise RuntimeError("UNAVAILABLE: the device went away")
        return real(*args)

    eng._decode_fn = flaky
    done, stats = eng.serve(_trace(), robust=RobustConfig(
        retry_backoff_s=0.0))
    assert _streams(done) == _streams(clean)
    assert stats["decode_retries"] == 1 and eng.decode_retries_total == 1

    eng = _engine("bf16")
    real, failing = eng._decode_fn, []

    def broken(ids, tokens, poison):
        if eng._decode_calls == 3:  # every attempt of the third call
            failing[:] = ids.tolist()
            raise RuntimeError("UNAVAILABLE: the device went away")
        return real(ids, tokens, poison)

    eng._decode_fn = broken
    sched = Scheduler(eng, robust=RobustConfig(decode_retries=1,
                                               retry_backoff_s=0.0))
    done = sched.run(_trace())
    failed = {c.rid for c in done if c.finish_reason == "failed"}
    assert failed and len(failed) <= len(failing)
    assert sched.stats()["requests_failed"] == len(failed)
    for c in done:
        if c.rid not in failed:
            assert c.tokens.tolist() == _streams(clean)[c.rid]

    eng = _engine("bf16")
    eng._decode_fn = lambda *args: (_ for _ in ()).throw(
        ValueError("a bug, not a transient fault"))
    with pytest.raises(ValueError, match="a bug"):
        eng.serve(_trace())


def test_every_slot_non_finite_escalates():
    eng = _engine("bf16", batch_buckets=(2,))
    sched = Scheduler(eng)
    for rid in range(2):
        sched.submit(Request(rid=rid, prompt=np.arange(5) + rid,
                             max_new_tokens=6))
    nan = torch.full((), float("nan"))
    with torch.no_grad():
        eng.model.final_layernorm.weight.copy_(nan)
    try:
        with pytest.raises(NonFiniteError):
            sched.run()
    finally:
        with torch.no_grad():
            eng.model.final_layernorm.weight.fill_(1.0)
    assert sched.health.all_slots_nonfinite == 1


def test_admission_shedding_deadlines_and_drain():
    eng = _engine("bf16")
    sched = Scheduler(eng, robust=RobustConfig(max_pending=2))
    assert sched.submit(Request(rid=0, prompt=np.arange(40),
                                max_new_tokens=2)) is False  # > bucket 32
    assert sched.submit(Request(rid=1, prompt=np.arange(30),
                                max_new_tokens=100)) is False  # > 128
    assert all(sched.submit(Request(rid=i, prompt=np.arange(4),
                                    max_new_tokens=3)) for i in (2, 3))
    assert sched.submit(Request(rid=4, prompt=np.arange(4),
                                max_new_tokens=3)) is False  # queue full
    assert sched.submit(Request(rid=2, prompt=np.arange(4),
                                max_new_tokens=3)) is False  # duplicate
    assert [r.reason for r in sched.rejected] == [
        "prompt_too_long", "budget_too_long", "queue_full", "duplicate_rid"]
    done = sched.run()
    assert sorted(c.rid for c in done) == [2, 3]
    shed = Scheduler(eng, robust=RobustConfig(
        max_pending=1, admission_policy="shed_oldest"))
    shed.submit(Request(rid=0, prompt=np.arange(4), max_new_tokens=3))
    shed.submit(Request(rid=1, prompt=np.arange(4), max_new_tokens=3))
    assert [r.reason for r in shed.rejected] == ["shed"]
    assert [c.rid for c in shed.run()] == [1]
    # a total-latency deadline that has passed evicts an active request
    # (a virtual clock: 10 s a reading)
    clock = iter(np.arange(0.0, 1000.0, 10.0))
    late = Scheduler(eng, clock=lambda: next(clock),
                     robust=RobustConfig(total_deadline_s=25.0))
    late.submit(Request(rid=0, prompt=np.arange(4), max_new_tokens=50))
    rec = late.run()[0]
    assert rec.finish_reason == "deadline_exceeded"
    assert 1 <= len(rec.tokens) < 50 and late.health.expired == 1
    drained = Scheduler(eng)
    drained.submit(Request(rid=0, prompt=np.arange(4), max_new_tokens=50))
    drained.drain()
    assert drained.run()[0].finish_reason == "drained"
    assert drained.drain_report.cancelled_pending == 1


def test_not_ported_features_raise(monkeypatch):
    """A slot-sharded data axis (the fleet) still raises; the preflight
    and the preemption guard (telemetry, resilience) run: the decode
    peak is the weights and the store on the CPU (no graph pool), a
    strict preflight under it refuses the engine, and a guard whose
    signal arrived drains the run."""
    from apex_tpu_torch.resilience import PreemptionGuard
    from apex_tpu_torch.serving import ServeMesh
    from apex_tpu_torch.telemetry.memory import MemoryBudgetError

    model = _models()[2]
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(model, ServeConfig(**SERVE),
                    mesh=ServeMesh(("data", "tp"), (2, 1)))
    eng0 = ServeEngine(model, ServeConfig(**SERVE, preflight=True))
    rep = eng0.memory_report
    assert rep["peak_bytes"] == eng0.weight_bytes() + eng0.kv_cache_bytes()
    assert rep["over_budget"] is False
    monkeypatch.setenv("APEX_TPU_HBM_GB", str((rep["peak_bytes"] - 1000)
                                              / 1e9))
    with pytest.raises(MemoryBudgetError, match="exceeds"):
        ServeEngine(model, ServeConfig(**SERVE, preflight_strict=True))
    monkeypatch.delenv("APEX_TPU_HBM_GB")
    guard = PreemptionGuard(signals=())
    guard.trigger()
    done, _ = eng0.serve([Request(rid=0, prompt=np.arange(4),
                                  max_new_tokens=3)], guard=guard)
    assert [c.finish_reason for c in done] == ["drained"]
    # model_axis "tp" is JAX's default, accepted; a mesh must be the
    # port's ServeMesh
    assert ServeEngine(model, ServeConfig(**SERVE, model_axis="tp")).tp == 1
    with pytest.raises(TypeError, match="ServeMesh"):
        ServeEngine(model, ServeConfig(**SERVE), mesh=object())
    eng = _engine()
    with pytest.raises(ValueError, match="num_slots"):
        ServeEngine(model, ServeConfig(batch_buckets=(8,), num_slots=4))
    with pytest.raises(ValueError, match="pad slot"):
        eng.decode([0, 1, 2], [1, 2, 3], pad_slot_ids=[])


def test_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(GPTModel(TransformerConfig(**KW)))
