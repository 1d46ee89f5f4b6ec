"""apex_tpu_torch's prefix-cached serving and KV migration against
apex_tpu's on the CPU: ``PrefixStore``, the prefix-cached engines (plain
and speculative, bf16 and int8 stores), ``Scheduler.extract_unfinished``,
``ServeEngine.extract_kv_state`` with ``kv_payload_crc``, a migrated
continuation resumed on a second engine, and the bucket ladder's keys.

The models are the JAX package's own speculative/prefix serving test
models (``tests/L0/test_serving_spec.py``): a 2-layer Llama-shaped target
(hidden 48, 4 heads in 2 groups, RMSNorm, RoPE, SwiGLU, vocab 96, 64
positions) and an independent 1-layer draft (hidden 32), fp32 compute,
initialised in JAX and carried to the port through ``from_jax_params``.
The JAX side runs its decode, window and quantize kernels in Pallas
interpret mode and keeps its ladder at (2, 4) x (8, 16): each bucket is
an ahead-of-time compile.

Tolerances: token streams, prefix cuts, extracted records and store
statistics are compared exactly. A migration payload's K/V below the
slot's level: the bf16-mode rows (fp32 compute here) within 1e-5 of
JAX's, as the two packages' fp32 projections differ in the last place;
the int8-mode rows within one grid step of their row's absmax
(absmax / 127) plus that 1e-5, as values a last place apart may round to
neighbouring codes.
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
from apex_tpu.serving import ServeConfig as JaxServeConfig
from apex_tpu.serving import ServeEngine as JaxServeEngine
from apex_tpu.serving import scheduler as jax_sched
from apex_tpu.serving import synthetic_trace as jax_synthetic_trace
from apex_tpu.serving.prefix_cache import PrefixStore as JaxPrefixStore
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.models import GPTModel, TransformerConfig, from_jax_params
from apex_tpu_torch.serving import (
    PrefixStore,
    Request,
    Scheduler,
    ServeConfig,
    ServeEngine,
    kv_payload_crc,
    synthetic_trace,
)
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 96
KW = dict(num_attention_heads=4, num_query_groups=2, vocab_size=VOCAB,
          max_position_embeddings=64, normalization="rmsnorm",
          position_embedding_type="rope", activation="swiglu")
SERVE = dict(batch_buckets=(2, 4), prefill_buckets=(8, 16), num_slots=4,
             prefix_cache=True, prefix_min_len=4)
TRACE = dict(seed=5, mean_interarrival=0.4, prompt_lens=(3, 5),
             max_new=(5, 8), vocab_size=VOCAB, shared_prefix_len=7,
             shared_frac=0.8)
K = 3


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


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX target, params, JAX draft, params, port target, port draft)
    with the same weights, fp32 compute."""
    rng = np.random.RandomState(0)
    out = []
    for layers, hidden, key in ((2, 48, 1), (1, 32, 7)):
        jcfg = JaxConfig(**KW, num_layers=layers, hidden_size=hidden,
                         compute_dtype=jnp.float32,
                         use_flash_attention=False)
        params = JaxGPTModel(jcfg).init(
            jax.random.PRNGKey(key),
            jnp.asarray(rng.randint(0, VOCAB, (1, 8))))["params"]
        cfg = TransformerConfig(**KW, num_layers=layers, hidden_size=hidden,
                                compute_dtype=torch.float32)
        model = GPTModel(cfg, device="cpu")
        model.load_state_dict(from_jax_params(
            jax.tree.map(np.asarray, params), cfg))
        out.append((JaxGPTModel(jcfg, decode=True), params, model))
    (tj, tp, tt), (dj, dp, dt) = out
    return tj, tp, dj, dp, tt, dt


def _trace(n=6):
    return synthetic_trace(n, **TRACE)


def _streams(completed):
    return {c.rid: np.asarray(c.tokens).tolist() for c in completed}


def _jax_engine(mode, spec):
    tj, tp, dj, dp, _, _ = _models()
    extra = dict(draft_model=dj, draft_params=dp,
                 num_draft_tokens=K) if spec else {}
    return JaxServeEngine(tj, tp, JaxServeConfig(**SERVE, cache_mode=mode,
                                                 **extra))


def _port_engine(mode, spec, **kw):
    _, _, _, _, tt, dt = _models()
    extra = dict(draft_model=dt, num_draft_tokens=K) if spec else {}
    return ServeEngine(tt, ServeConfig(**{**SERVE, **kw}, cache_mode=mode,
                                       **extra))


def _hits_log(engine):
    """Record ``last_prefill_hits`` after every prefill call of
    ``engine`` (an instance attribute shadows the method)."""
    log = []
    prefill = engine.prefill

    def run(*args, **kw):
        out = prefill(*args, **kw)
        log.append(list(engine.last_prefill_hits))
        return out

    engine.prefill = run
    return log


PREFIX_KEYS = ("prefix_lookups", "prefix_hits", "prefix_hit_rate",
               "prefix_hit_tokens", "prefix_store_entries")


@functools.lru_cache(maxsize=None)
def _served(mode, spec):
    """Two passes of the shared-prefix trace through one JAX and one port
    prefix-cached engine: (streams, hit logs, stats) of each side."""
    jeng, peng = _jax_engine(mode, spec), _port_engine(mode, spec)
    jlog, plog = _hits_log(jeng), _hits_log(peng)
    out = []
    for _ in range(2):  # the second pass hits every cached prompt
        jdone, jstats = jeng.serve(jax_synthetic_trace(6, **TRACE))
        pdone, pstats = peng.serve(_trace())
        out.append((_streams(jdone), _streams(pdone), jstats, pstats))
    return out, jlog, plog, jeng, peng


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _rows(n):
    """A stand-in raw row of ``n`` fp32 values for each side."""
    return ({"k": np.zeros(n, np.float32)},
            {"keys": [torch.zeros(n)],
             "lengths": torch.zeros(1, dtype=torch.int32)})


def test_prefix_store_matches_jax_op_for_op():
    rs = np.random.RandomState(0)
    sys_a = rs.randint(0, 50, 9)
    sys_b = rs.randint(0, 50, 6)
    jax_s = JaxPrefixStore(max_entries=3, min_len=4)
    port_s = PrefixStore(max_entries=3, min_len=4)
    prompts = [np.concatenate([sys_a, rs.randint(0, 50, n)])
               for n in (3, 5, 1)]
    prompts += [sys_a[:4], sys_a[:5], np.concatenate([sys_b, [1, 2]]),
                np.concatenate([sys_b, [1, 2, 3]]), sys_b[:3],
                np.concatenate([sys_a, [7]]), rs.randint(0, 50, 12)]
    ops = []
    for i, p in enumerate(prompts):
        ops.append(("lookup", p, f"s{i % 2}"))
        ops.append(("covers", p, None))
        ops.append(("insert", p, f"s{i % 3}" if i % 4 else None))
        ops.append(("lookup", p[:-1], None))
    ops += [("lookup", p, "s0") for p in prompts]
    for op, p, scope in ops:
        if op == "lookup":
            (cj, ej), (cp, ep) = (s.lookup(p, scope=scope)
                                  for s in (jax_s, port_s))
            assert cj == cp and (ej is None) == (ep is None)
            if ej is not None:
                assert ej.tokens.tolist() == ep.tokens.tolist()
        elif op == "covers":
            assert jax_s.covers(p) == port_s.covers(p)
        else:
            jr, pr = _rows(8 + len(p))
            ej = jax_s.insert(p, jr, scope=scope)
            ep = port_s.insert(p, pr, scope=scope)
            assert (ej is None) == (ep is None)
        assert len(jax_s) == len(port_s)
    sj, sp = jax_s.stats(), port_s.stats()
    assert sp["evictions"] > 0 and sp["hits"] > 0 and sp["by_scope"]
    # the port's stand-in row carries a 4-byte level beside the same K
    assert sp.pop("bytes") == sj.pop("bytes") + 4 * sp["entries"]
    assert sp == sj
    for scope in ("s0", "s1", "s2", "none"):
        assert port_s.scope_stats(scope) == jax_s.scope_stats(scope)
    with pytest.raises(ValueError, match="max_entries"):
        PrefixStore(max_entries=0)


# ---------------------------------------------------------------------------
# the prefix-cached engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_prefix_engine_matches_jax(mode, spec):
    passes, jlog, plog, jeng, peng = _served(mode, spec)
    for jstreams, pstreams, jstats, pstats in passes:
        assert pstreams == jstreams
        for key in PREFIX_KEYS:
            assert pstats[key] == jstats[key], key
        assert (pstats["ttft_p50_prefix_hit_ms"] is None) == (
            jstats["ttft_p50_prefix_hit_ms"] is None)
        if spec:
            assert pstats["acceptance_rate"] == jstats["acceptance_rate"]
    # every prefill call looked up the same cuts
    assert plog == jlog and any(c for call in plog for c in call)
    assert passes[1][3]["prefix_hits"] > passes[0][3]["prefix_hits"]
    # entries hold full raw rows: the same K/V bytes; JAX keeps one
    # int32 fill level a layer, the port one a row (the JAX rows' other
    # bookkeeping leaves are those levels)
    model = _models()[4]
    levels = 4 * (model.num_layers - 1)
    if spec:
        levels += 4 * (_models()[5].num_layers - 1)
    entries = passes[1][3]["prefix_store_entries"]
    assert passes[1][3]["prefix_store_bytes"] == (
        passes[1][2]["prefix_store_bytes"] - levels * entries)
    # the streams are also the engine's without a prefix cache
    plain, _ = _port_engine(mode, spec, prefix_cache=False).serve(_trace())
    assert _streams(plain) == passes[0][1]


def test_prefix_engine_refuses_and_adopts():
    eng = _port_engine("bf16", False)
    shared = PrefixStore(max_entries=2, min_len=4)
    assert eng.adopt_prefix_store(shared) is shared
    with pytest.raises(ValueError, match="prefix_cache"):
        _port_engine("bf16", False, prefix_cache=False).adopt_prefix_store(
            shared)
    # two engines on one store: each reads its own scope's counters
    other = ServeEngine(_models()[4], ServeConfig(**SERVE), name="other")
    other.adopt_prefix_store(shared)
    p = _trace()[0].prompt
    eng.prefill([0], [p], pad_slot_ids=[1, 2, 3])
    other.prefill([0], [p], pad_slot_ids=[1, 2, 3])
    assert (eng.prefix_lookups, eng.prefix_hits) == (1, 0)
    assert (other.prefix_lookups, other.prefix_hits) == (1, 1)
    assert other.prefix_hit_tokens == len(p) - 1
    assert other.last_prefill_hits == [len(p) - 1]


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def _jax_kv(rows):
    """(keys, values, levels) of a JAX raw row tree: per layer
    ``cached_key`` / ``cached_value`` [T, 1, g, d] in layer order, and
    each layer's ``cache_index``."""
    leaves = jax.tree_util.tree_flatten_with_path(rows)[0]
    named = {tuple(str(getattr(e, "key", e)) for e in path): np.asarray(x)
             for path, x in leaves}

    def layer(names):
        return int(next(n for n in names if n.startswith("layer_"))[6:])

    def pick(leaf):
        return [x for _, x in sorted((layer(n), x) for n, x in named.items()
                                     if n[-1] == leaf)]

    return pick("cached_key"), pick("cached_value"), pick("cache_index")


def _donor_run(engine, scheduler_cls, trace, ticks):
    sched = scheduler_cls(engine)
    for r in trace:
        sched.submit(r)
    for _ in range(ticks):
        sched.step()
    return sched, sched.extract_unfinished("migrated")


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_migration_payloads_match_jax(mode):
    # the engines of the served traces, their prefix stores warm alike
    jeng, peng = _served(mode, False)[3:]
    _, jrecs = _donor_run(jeng, jax_sched.Scheduler,
                          jax_synthetic_trace(6, **TRACE), 3)
    psched, precs = _donor_run(peng, Scheduler, _trace(), 3)
    assert not psched.active and not psched.pending
    key = [(r["request"].rid, r["tokens"], r["where"], r["slot"])
           for r in precs]
    assert key == [(r["request"].rid, [int(t) for t in r["tokens"]],
                    r["where"], r["slot"]) for r in jrecs]
    slots = [r["slot"] for r in precs if r["slot"] is not None]
    assert slots and any(r["where"] == "pending" for r in precs)
    jpay, ppay = jeng.extract_kv_state(slots), peng.extract_kv_state(slots)
    for slot in slots:
        jp, pp = jpay[slot], ppay[slot]
        assert pp["length"] == jp["length"] > 0
        assert (pp["tp"], pp["cache_mode"]) == (1, mode)
        assert pp["crc"] == kv_payload_crc(pp)
        jk, jv, jlev = _jax_kv(jp["rows"])
        assert [int(x) for x in jlev] == [pp["length"]] * len(jk)
        assert pp["rows"]["lengths"].tolist() == [pp["length"]]
        n = pp["length"]
        for want, got in zip(jk + jv, pp["rows"]["keys"]
                             + pp["rows"]["values"]):
            assert tuple(got.shape) == want.shape
            err = np.abs(got[:n].numpy() - want[:n])
            step = 0.0
            if mode == "int8":
                step = np.abs(want[:n]).reshape(n, -1).max(-1) / 127.0
                step = step.reshape((n,) + (1,) * (want.ndim - 1))
            assert (err <= 1e-5 + step).all(), err.max()
    # a flipped byte, or a changed length, fails the check
    pp = ppay[slots[0]]
    leaf = pp["rows"]["values"][-1]
    flat = leaf.view(-1).view(torch.uint8)
    flat[5] ^= 1
    assert kv_payload_crc(pp) != pp["crc"]
    flat[5] ^= 1
    assert kv_payload_crc(pp) == pp["crc"]
    assert kv_payload_crc({**pp, "length": pp["length"] + 1}) != pp["crc"]
    # the layout is checked: tp = 1 rows are not a tp = 2 engine's
    with pytest.raises(ValueError, match="tp=2|q/scale"):
        peng.spec.consolidate_host_rows(ppay[slots[0]]["rows"], tp=2)
    with pytest.raises(ValueError, match="layout"):
        peng.spec.consolidate_host_rows(
            {"keys": [torch.zeros(3)], "values": [],
             "lengths": torch.zeros(1)})
    with pytest.raises(ValueError, match="which"):
        psched.extract_unfinished(which="some")


@pytest.mark.parametrize("mode,spec", [("bf16", False), ("int8", True)])
def test_migrated_continuation_resumes_the_stream(mode, spec):
    """The survivor half of a migration, as the JAX fleet's
    ``_seed_prefix_from_payload`` does it: each payload's rows go into a
    second engine's prefix store under the continuation's first
    ``length`` tokens, its prefill runs a one-token suffix, and the
    completed streams are the unkilled run's."""
    want = _served(mode, spec)[0][0][1]   # the port's unkilled streams
    donor = _port_engine(mode, spec)
    _, recs = _donor_run(donor, Scheduler, _trace(), 3)
    pays = donor.extract_kv_state([r["slot"] for r in recs
                                   if r["slot"] is not None])
    survivor = _port_engine(mode, spec)
    assert survivor.seed_row_template().keys() == pays[
        recs[0]["slot"]]["rows"].keys()
    conts, carried = [], {}
    for r in recs:
        carry = np.concatenate([r["request"].prompt,
                                np.asarray(r["tokens"], np.int32)])
        if r["slot"] is not None:
            pay = pays[r["slot"]]
            assert kv_payload_crc(pay) == pay["crc"]
            cut = min(pay["length"], len(carry) - 1)
            assert cut == len(carry) - 1
            survivor.prefix_store.insert(carry[:cut], pay["rows"],
                                         pay["draft_rows"], scope="handoff")
            carried[r["request"].rid] = cut
        conts.append(Request(rid=r["request"].rid, prompt=carry,
                             max_new_tokens=r["request"].max_new_tokens
                             - len(r["tokens"])))
    cuts = {}
    prefill = survivor.prefill

    def logged(slot_ids, prompts, **kw):
        out = prefill(slot_ids, prompts, **kw)
        cuts.update((tuple(p.tolist()), c) for p, c in zip(
            prompts, survivor.last_prefill_hits))
        return out

    survivor.prefill = logged
    done, stats = survivor.serve(conts)
    got = {c.rid: r["tokens"] + np.asarray(c.tokens).tolist()
           for c, r in zip(sorted(done, key=lambda c: c.rid),
                           sorted(recs, key=lambda r: r["request"].rid))}
    assert got == {rid: want[rid] for rid in got}
    assert stats["requests_ok"] == len(conts)
    # every carried continuation hit its own prefix: a one-token suffix
    for c in conts:
        if c.rid in carried:
            assert cuts[tuple(c.prompt.tolist())] == carried[c.rid] \
                == len(c.prompt) - 1


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_ladder_keys_match_jax(spec):
    jeng = _served("bf16", spec)[3]
    peng = _port_engine("bf16", spec)
    ladder = peng.ladder()
    assert tuple(ladder["decode"]) == tuple(sorted(jeng._decode_exec))
    assert tuple(ladder["prefill"]) == tuple(sorted(jeng._prefill_exec))
    assert jeng.compile_count == len(ladder["decode"]) + len(
        ladder["prefill"]) == 2 * 2 + 2
    # the CPU captures nothing: the same bodies run eagerly
    assert peng.compile_count == 0
    assert peng.graph_seconds == 0.0 and peng.graph_pool is None
