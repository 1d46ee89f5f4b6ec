"""apex_tpu_torch's tensor-parallel serving across two real processes,
against JAX's over a two-device 'tp' mesh.

The port's launcher starts two gloo ranks over 127.0.0.1 (as
``tests/test_torch_tp_world2.py`` does); each calls
``initialize_model_parallel(2)``, loads its shard of the same tp = 1
weights (initialised here in JAX and split by ``split_params_for_tp``)
and runs, writing its results under OUT:

- a bf16 all-reduce of two partials that must round (the row-parallel
  reduce), against JAX's bf16 ``psum``;
- a Llama-shaped GQA GPT (2 layers, hidden 48, 4 heads in 2 groups,
  SwiGLU, RMSNorm, RoPE, vocab 96) and a GPT-2-shaped MHA one: the
  prefill, a decode step and the training forward, their full-vocabulary
  logits;
- ``tensor_parallel_generate`` and ``tensor_parallel_beam_search`` on
  the GQA model;
- the tp = 2 engine in bf16, in int8, and speculative with a prefix
  cache (a 1-layer draft of hidden 32), on one shared-prefix trace;
- ``extract_kv_state`` of the unfinished requests after three scheduler
  steps; a tp = 1 port engine here is seeded from rank 0's payloads and
  resumes them;
- a total-latency deadline read from each rank's own clock (rank 0's
  runs, rank 1's stands still): rank 0 decides for both;
- a dense ``DeepseekModel`` (2 layers, 4 heads) and ``BertModel`` at
  tp = 2: their logits.

This file runs JAX's counterparts on the same weights: ``shard_map``
over 'tp' (jitted) for the logits, JAX's ``tensor_parallel_generate`` and
``tensor_parallel_beam_search``, and JAX's tp = 2 ``ServeEngine`` on a
(data=1, tp=2) mesh (one batch bucket, one prefill bucket), its Pallas
kernels through their plain references, as JAX's own tp serving tests
run them on the CPU. Compute is fp32 on both sides.

Tolerances: the two ranks' results are bit-identical. Token streams,
beams, finish reasons and the bf16 reduce are compared exactly; logits
and beam scores within 2e-5 of the array's largest magnitude (the two
libraries sum fp32 products in their own orders); a payload's K/V below
the slot's level within 1e-5, as the prefix cache's own test holds a tp
= 1 payload. Each rank has 120 s.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import generation as jax_gen
from apex_tpu.models.mla import DeepseekModel as JaxDeepseekModel
from apex_tpu.models.mla import MLAConfig as JaxMLAConfig
from apex_tpu.models.tp_split import split_params_for_tp as jax_split
from apex_tpu.serving import ServeConfig as JaxServeConfig
from apex_tpu.serving import ServeEngine as JaxServeEngine
from apex_tpu.serving import scheduler as jax_sched
from apex_tpu.serving import synthetic_trace as jax_synthetic_trace
from apex_tpu.testing import shard_map
from apex_tpu.transformer import parallel_state as jax_ps
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
LOGIT_TOL, KV_TOL = 2e-5, 1e-5
TICKS = 3

WORKER = r"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.models import (
    BertModel,
    DeepseekModel,
    GPTModel,
    MLAConfig,
    TransformerConfig,
    decode_step,
    init_cache,
    prefill,
    rank_state_dict,
    split_mla_params_for_tp,
    split_params_for_tp,
    tensor_parallel_beam_search,
    tensor_parallel_generate,
)
from apex_tpu_torch.models.params import from_jax_name
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.serving import (
    Request,
    RobustConfig,
    Scheduler,
    ServeConfig,
    ServeEngine,
    ServeMesh,
    synthetic_trace,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.enums import AttnMaskType

OUT = sys.argv[1]
S = json.load(open(f"{OUT}/shared.json"))  # the test's settings
C = S["configs"]
PROMPT = np.array(S["prompt"], np.int64)
PADDING = np.array(S["padding"], np.int64)
NEW, BEAMS, K, TICKS = S["new"], S["beams"], S["k"], S["ticks"]
SERVE, TRACE = ({k: tuple(v) if isinstance(v, list) else v
                 for k, v in S[name].items()} for name in ("serve", "trace"))
torch.set_num_threads(1)
initialize_distributed(device="cpu")  # the launcher's env
rank = dist.get_rank()
ps.initialize_model_parallel(2)
out, meta = {}, {}


def weights(name):
    arrays = np.load(f"{OUT}/{name}.npz")
    return {from_jax_name(k): torch.from_numpy(arrays[k]) for k in arrays}


def build(name):
    if name == "mla":
        cfg = MLAConfig(**C[name], compute_dtype=torch.float32)
        model = DeepseekModel(cfg, device="cpu")
        split = split_mla_params_for_tp
    elif name == "bert":
        cfg = TransformerConfig(**C[name], compute_dtype=torch.float32,
                                attn_mask_type=AttnMaskType.padding)
        model = BertModel(cfg, num_tokentypes=0, device="cpu")
        split = split_params_for_tp
    else:
        cfg = TransformerConfig(**C[name], compute_dtype=torch.float32)
        model = GPTModel(cfg, device="cpu")
        split = split_params_for_tp
    model.load_state_dict(rank_state_dict(split(cfg, weights(name), 2),
                                          rank))
    return model


def full(x):
    return tp.gather_from_tensor_model_parallel_region(x)


# the row-parallel reduce of two bf16 partials
part = torch.tensor(S["partials"][rank], dtype=torch.float32).to(
    torch.bfloat16)
red = tp.reduce_from_tensor_model_parallel_region(part)
out["bf16_reduce"] = red.view(torch.int16).numpy()

prompt = torch.from_numpy(PROMPT)
with torch.no_grad():
    for name in ("gqa", "mha"):
        model = build(name)
        cache = init_cache(model, 2)
        _, l0 = prefill(model, cache, prompt,
                        torch.arange(prompt.shape[1])[None])
        nxt = torch.argmax(l0, -1)
        _, l1 = decode_step(model, cache, nxt[:, None],
                            torch.full((2, 1), prompt.shape[1]))
        out[f"{name}_prefill"], out[f"{name}_step"] = l0, l1
        out[f"{name}_train"] = full(model(prompt))
    gqa = build("gqa")
    out["generate"] = tensor_parallel_generate(gqa, None, prompt, NEW)
    beams, scores = tensor_parallel_beam_search(gqa, None, prompt, NEW,
                                                BEAMS)
    out["beam"], out["beam_scores"] = beams, scores
    mla = build("mla")
    out["mla_train"] = full(mla(prompt))
    logits, _ = mla.decode_prefill(prompt)
    out["mla_prefill"] = full(logits)
    bert = build("bert")
    mlm, nsp = bert(prompt, torch.from_numpy(PADDING))
    out["bert_mlm"], out["bert_nsp"] = full(mlm), nsp

draft = build("draft")
mesh = ServeMesh.from_grid()


def engine(kind):
    kw, params = dict(SERVE), None
    if kind == "spec_prefix":  # loaded through split_params_for_tp
        kw.update(draft_model=draft, draft_params=weights("draft"),
                  num_draft_tokens=K, prefix_cache=True, prefix_min_len=4)
        params = weights("gqa")
    return ServeEngine(gqa, ServeConfig(**kw, cache_mode=(
        "int8" if kind == "int8" else "bf16")), mesh=mesh, params=params)


streams = {}
for kind in ("bf16", "int8", "spec_prefix"):
    done, stats = engine(kind).serve(synthetic_trace(6, **TRACE))
    streams[kind] = {c.rid: c.tokens.tolist() for c in done}
    meta[f"{kind}_wall_s"] = stats["wall_s"]
meta["streams"] = streams

# the donor half of a migration after TICKS steps
donor = engine("bf16")
sched = Scheduler(donor)
for r in synthetic_trace(6, **TRACE):
    sched.submit(r)
for _ in range(TICKS):
    sched.step()
recs = sched.extract_unfinished("migrated")
slots = [r["slot"] for r in recs if r["slot"] is not None]
pays = donor.extract_kv_state(slots)
meta["records"] = [(r["request"].rid, r["tokens"], r["where"], r["slot"])
                   for r in recs]
meta["payloads"] = {s: (p["length"], p["tp"], p["crc"])
                    for s, p in pays.items()}
for s, p in pays.items():
    for name in ("keys", "values"):
        for i, x in enumerate(p["rows"][name]):
            out[f"pay{s}_{name}{i}"] = x

# a deadline on each rank's own clock: rank 0's advances 10 s a reading
if rank == 0:
    ticks = iter(np.arange(0.0, 1e4, 10.0))
    clock = lambda: float(next(ticks))  # noqa: E731
else:
    clock = lambda: 0.0  # noqa: E731
late = Scheduler(engine("bf16"), clock=clock,
                 robust=RobustConfig(total_deadline_s=25.0))
for rid in range(2):
    late.submit(Request(rid=rid, prompt=PROMPT[rid], max_new_tokens=30))
meta["deadline"] = {c.rid: (c.finish_reason, len(c.tokens))
                    for c in late.run()}
meta["deadline_stats"] = late.stats()["wall_s"]

np.savez(f"{OUT}/rank{rank}.npz",
         **{k: np.asarray(v) for k, v in out.items()})
with open(f"{OUT}/rank{rank}.json", "w") as f:
    json.dump(meta, f)
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


GQA = dict(hidden_size=48, num_layers=2, num_attention_heads=4,
           num_query_groups=2, vocab_size=96, max_position_embeddings=64,
           normalization="rmsnorm", position_embedding_type="rope",
           activation="swiglu", use_flash_attention=False)
CONFIGS = {"gqa": GQA, "draft": dict(GQA, hidden_size=32, num_layers=1),
           "mha": dict(hidden_size=48, num_layers=2, num_attention_heads=4,
                       vocab_size=96, max_position_embeddings=64,
                       use_flash_attention=False),
           "bert": dict(hidden_size=48, num_layers=2, num_attention_heads=4,
                        vocab_size=96, max_position_embeddings=32,
                        use_flash_attention=False),
           "mla": dict(vocab_size=96, hidden_size=32, num_layers=2,
                       num_heads=4, q_lora_rank=None, kv_lora_rank=16,
                       qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                       ffn_hidden_size=48, max_decode_length=32)}
PROMPT = np.random.RandomState(2).randint(0, 96, (2, 6)).astype(np.int64)
PADDING = np.array([[1] * 6, [1] * 4 + [0] * 2], np.int64)
NEW, BEAMS, K = 8, 3, 3
SERVE = dict(batch_buckets=(2,), prefill_buckets=(16,), num_slots=4)
TRACE = dict(seed=5, mean_interarrival=0.4, prompt_lens=(3, 5),
             max_new=(5, 8), vocab_size=96, shared_prefix_len=7,
             shared_frac=0.8)
# two ranks' bf16 partials whose sums need rounding
PARTIALS = [(np.random.RandomState(11 + r).randn(64) * 8).astype(np.float32)
            for r in range(WORLD)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@functools.lru_cache(maxsize=None)
def _params():
    """The tp = 1 weights, initialised in JAX (grid unbound): name ->
    (JAX config, decode-model kwargs, flax params)."""
    jax_ps.destroy_model_parallel()
    C = CONFIGS
    toks = jnp.asarray(PROMPT[:1, :4])
    out = {}
    for i, name in enumerate(("gqa", "draft", "mha")):
        cfg = JaxConfig(**C[name], compute_dtype=jnp.float32)
        out[name] = (cfg, JaxGPTModel(cfg).init(jax.random.PRNGKey(i),
                                                toks)["params"])
    cfg = JaxMLAConfig(**C["mla"], compute_dtype=jnp.float32)
    out["mla"] = (cfg, JaxDeepseekModel(cfg).init(jax.random.PRNGKey(5),
                                                  toks)["params"])
    cfg = JaxConfig(**C["bert"], compute_dtype=jnp.float32,
                    attn_mask_type=JaxMaskType.padding)
    out["bert"] = (cfg, JaxBertModel(cfg).init(
        jax.random.PRNGKey(6), toks, jnp.ones((1, 4), jnp.int32))["params"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("tp_serving_world2")
    for name, (_, params) in _params().items():
        np.savez(tmp_path / f"{name}.npz", **dict(_flat(params)))
    (tmp_path / "shared.json").write_text(json.dumps(dict(
        configs=CONFIGS, prompt=PROMPT.tolist(), padding=PADDING.tolist(),
        new=NEW, beams=BEAMS, k=K, ticks=TICKS, serve=SERVE, trace=TRACE,
        partials=[p.tolist() for p in PARTIALS])))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nnodes", str(WORLD), "--node_rank", str(r), "--coordinator",
         f"127.0.0.1:{port}", str(script), str(tmp_path)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=120)
            assert p.returncode == 0 and f"RANK{r}_OK" in log, (
                f"rank {r} failed:\n{log}")
    finally:
        for p in procs:
            p.kill()
    return [(dict(np.load(tmp_path / f"rank{r}.npz")),
             json.loads((tmp_path / f"rank{r}.json").read_text()))
            for r in range(WORLD)]


@pytest.fixture
def mesh():
    """JAX's grid at tp = 2 (the flax layers size their shards from it)
    and its (data=1, tp=2) mesh."""
    jax_ps.initialize_model_parallel(tensor_model_parallel_size_=2,
                                     devices=jax.devices()[:WORLD])
    try:
        yield Mesh(np.asarray(jax.devices()[:WORLD]).reshape(1, WORLD),
                   ("data", "tp"))
    finally:
        jax_ps.destroy_model_parallel()


def _same_on_both(ranks, key):
    a, b = (r[0][key] for r in ranks)
    np.testing.assert_array_equal(a, b, err_msg=key)
    return a


def _close(got, want, key, tol=LOGIT_TOL):
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=key)


def _stacked(params):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), params)


def _unstack(sp):
    return jax.tree_util.tree_map(lambda a: a[0], sp)


def _gpt_stacked(name):
    cfg, params = _params()[name]
    return cfg, _stacked(jax_split(cfg, params, WORLD))


def test_bf16_reduce_rounds_as_jax_psum(ranks, mesh):
    parts = np.stack(PARTIALS).astype(jnp.bfloat16)
    f = shard_map(lambda x: jax.lax.psum(x[0], "tp"), mesh=mesh,
                  in_specs=(P("tp"),), out_specs=P())
    want = np.asarray(f(jnp.asarray(parts))).view(np.int16)
    got = _same_on_both(ranks, "bf16_reduce")
    np.testing.assert_array_equal(got, want)
    # the partials' fp32 sums do not all fit bf16: the rounding was tested
    exact = parts.astype(np.float32).sum(0)
    assert (exact != exact.astype(jnp.bfloat16).astype(np.float32)).any()


@pytest.mark.parametrize("name", ["gqa", "mha"])
def test_decode_and_training_logits_match_jax(ranks, mesh, name):
    cfg, sp = _gpt_stacked(name)
    dec = JaxGPTModel(cfg, decode=True)
    train = JaxGPTModel(cfg)
    prompt = jnp.asarray(PROMPT, jnp.int32)
    s = prompt.shape[1]

    def body(sp, toks):
        params = _unstack(sp)
        cache = jax_gen.init_cache(dec, 2, toks.dtype)
        cache, l0 = jax_gen.prefill(dec, params, cache, toks,
                                    jnp.arange(s)[None])
        nxt = jnp.argmax(l0, -1).astype(jnp.int32)
        _, l1 = jax_gen.decode_step(dec, params, cache, nxt[:, None],
                                    jnp.full((2, 1), s))
        full = jax_gen._full_vocab(train.apply({"params": params}, toks))
        return l0, l1, full

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("tp"), P()),
                          out_specs=(P(), P(), P())))
    for key, want in zip(("prefill", "step", "train"), f(sp, prompt)):
        got = _same_on_both(ranks, f"{name}_{key}")
        _close(got, np.asarray(want), f"{name}_{key}")


def test_generate_and_beam_search_match_jax(ranks, mesh):
    cfg, sp = _gpt_stacked("gqa")
    dec = JaxGPTModel(cfg, decode=True)
    prompt = jnp.asarray(PROMPT, jnp.int32)
    want = jax_gen.tensor_parallel_generate(dec, sp, prompt, NEW,
                                            mesh=mesh)
    np.testing.assert_array_equal(_same_on_both(ranks, "generate"),
                                  np.asarray(want))
    beams, scores = jax_gen.tensor_parallel_beam_search(
        dec, sp, prompt, NEW, BEAMS, mesh=mesh)
    np.testing.assert_array_equal(_same_on_both(ranks, "beam"),
                                  np.asarray(beams))
    _close(_same_on_both(ranks, "beam_scores"), np.asarray(scores), "scores")


def _jax_engine_run(kind, mesh):
    cfg, params = _params()["gqa"]
    kw = dict(SERVE)
    if kind == "spec_prefix":
        dcfg, dparams = _params()["draft"]
        kw.update(draft_model=JaxGPTModel(dcfg, decode=True),
                  draft_params=dparams, num_draft_tokens=K,
                  prefix_cache=True, prefix_min_len=4)
    eng = JaxServeEngine(JaxGPTModel(cfg, decode=True), params,
                         JaxServeConfig(**kw, cache_mode=(
                             "int8" if kind == "int8" else "bf16")),
                         mesh=mesh)
    done, _ = eng.serve(jax_synthetic_trace(6, **TRACE))
    return {str(c.rid): np.asarray(c.tokens).tolist() for c in done}


@pytest.mark.parametrize("kind", ["bf16", "int8", "spec_prefix"])
def test_engine_streams_match_jax(ranks, mesh, kind):
    got = [r[1]["streams"][kind] for r in ranks]
    assert got[0] == got[1]
    want = _jax_engine_run(kind, mesh)
    assert got[0] == want


def _jax_kv(rows):
    """(keys, values) of a JAX raw row tree, per layer in layer order."""
    attn = [rows["transformer"][f"layer_{i}"]["self_attention"]
            for i in range(len(rows["transformer"]))]
    return ([np.asarray(a["cached_key"]) for a in attn],
            [np.asarray(a["cached_value"]) for a in attn])


def test_extract_kv_state_matches_jax(ranks, mesh):
    meta = [r[1] for r in ranks]
    assert meta[0]["records"] == meta[1]["records"]
    assert meta[0]["payloads"] == meta[1]["payloads"]
    cfg, params = _params()["gqa"]
    jeng = JaxServeEngine(JaxGPTModel(cfg, decode=True), params,
                          JaxServeConfig(**SERVE), mesh=mesh)
    jsched = jax_sched.Scheduler(jeng)
    for r in jax_synthetic_trace(6, **TRACE):
        jsched.submit(r)
    for _ in range(TICKS):
        jsched.step()
    jrecs = jsched.extract_unfinished("migrated")
    assert [list(x) for x in meta[0]["records"]] == [
        [r["request"].rid, [int(t) for t in r["tokens"]], r["where"],
         r["slot"]] for r in jrecs]
    slots = [r["slot"] for r in jrecs if r["slot"] is not None]
    assert slots
    jpay = jeng.extract_kv_state(slots)
    for slot in slots:
        length, tp, crc = meta[0]["payloads"][str(slot)]
        assert (length, tp) == (jpay[slot]["length"], jpay[slot]["tp"]) \
            == (length, 2)
        jk, jv = _jax_kv(jpay[slot]["rows"])
        for name, want in (("keys", jk), ("values", jv)):
            for i, w in enumerate(want):
                got = _same_on_both(ranks, f"pay{slot}_{name}{i}")
                assert got.shape == w.shape == (64, 1, 2, 12)
                _close(got[:length], w[:length], f"{name}{i}", KV_TOL)


def test_tp2_payload_seeds_a_tp1_engine(ranks):
    """The survivor half at tp = 1: rank 0's payloads go into a tp = 1
    port engine's prefix store, and the continuations resume with the
    unkilled tp = 2 streams."""
    import torch

    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.models import from_jax_params
    from apex_tpu_torch.serving import (
        Request,
        ServeConfig,
        ServeEngine,
        kv_payload_crc,
        synthetic_trace,
    )

    jax_ps.destroy_model_parallel()
    arrays, meta = ranks[0]
    cfg = TransformerConfig(**CONFIGS["gqa"],
                            compute_dtype=torch.float32)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, _params()["gqa"][1]), cfg))
    survivor = ServeEngine(model, ServeConfig(**SERVE,
                                              prefix_cache=True))
    L = cfg.num_layers
    trace = {r.rid: r for r in synthetic_trace(6, **TRACE)}
    want = meta["streams"]["bf16"]
    conts, carried = [], {}
    for rid, tokens, where, slot in meta["records"]:
        r = trace[rid]
        carry = np.concatenate([r.prompt, np.asarray(tokens, np.int32)])
        if slot is not None:
            length, _, crc = meta["payloads"][str(slot)]
            rows = {name: [torch.from_numpy(arrays[f"pay{slot}_{name}{i}"])
                           for i in range(L)] for name in ("keys", "values")}
            rows["lengths"] = torch.tensor([length], dtype=torch.int32)
            pay = {"rows": rows, "draft_rows": None, "length": length}
            assert kv_payload_crc(pay) == crc
            cut = min(length, len(carry) - 1)
            survivor.prefix_store.insert(carry[:cut], rows, None,
                                         scope="handoff")
            carried[rid] = cut
        conts.append(Request(rid=rid, prompt=carry,
                             max_new_tokens=r.max_new_tokens - len(tokens)))
    assert carried
    done, stats = survivor.serve(conts)
    prior = {rid: tokens for rid, tokens, _, _ in meta["records"]}
    got = {str(c.rid): prior[c.rid] + np.asarray(c.tokens).tolist()
           for c in done}
    assert got == {rid: want[rid] for rid in got}
    assert stats["requests_ok"] == len(conts)
    assert survivor.prefix_hits >= len(carried)


def test_a_deadline_expires_the_same_request_on_both_ranks(ranks):
    meta = [r[1] for r in ranks]
    assert meta[0]["deadline"] == meta[1]["deadline"]
    reasons = [reason for reason, _ in meta[0]["deadline"].values()]
    assert "deadline_exceeded" in reasons
    # rank 1's clock stands still: alone it would expire nothing; its
    # stats are rank 0's
    assert meta[0]["deadline_stats"] == meta[1]["deadline_stats"]


def test_deepseek_logits_match_jax(ranks, mesh):
    from apex_tpu.models.tp_split import split_mla_params_for_tp

    cfg, params = _params()["mla"]
    sp = _stacked(split_mla_params_for_tp(cfg, params, WORLD))
    model = JaxDeepseekModel(cfg)
    prompt = jnp.asarray(PROMPT, jnp.int32)

    def body(sp, toks):
        params = _unstack(sp)
        train = jax_gen._full_vocab(model.apply({"params": params}, toks))
        pre, _ = model.apply({"params": params}, toks, mutable=["cache"],
                             method=JaxDeepseekModel.decode_prefill)
        return train, jax_gen._full_vocab(pre)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("tp"), P()),
                          out_specs=(P(), P())))
    for key, want in zip(("mla_train", "mla_prefill"), f(sp, prompt)):
        _close(_same_on_both(ranks, key), np.asarray(want), key)


def test_bert_mlm_logits_match_jax(ranks, mesh):
    """The port's split of BERT (its heads below the vocabulary
    projection replicate) fed to JAX's model under shard_map."""
    from apex_tpu_torch.models import TransformerConfig
    from apex_tpu_torch.models import from_jax_params, split_params_for_tp
    from apex_tpu_torch.transformer.enums import AttnMaskType

    cfg, params = _params()["bert"]
    tcfg = TransformerConfig(**CONFIGS["bert"],
                             attn_mask_type=AttnMaskType.padding)
    split = split_params_for_tp(tcfg, from_jax_params(
        jax.tree.map(np.asarray, params)), WORLD)
    tree = {}  # the flax tree: layers.<i> back to the scope layer_<i>
    for name, value in split.items():
        node = tree
        parts = name.replace("layers.", "layer_").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value.numpy())
    model = JaxBertModel(cfg)

    def body(sp, toks, pad):
        mlm, nsp = model.apply({"params": _unstack(sp)}, toks, pad)
        return jax_gen._full_vocab(mlm), nsp

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("tp"), P(), P()),
                          out_specs=(P(), P())))
    mlm, nsp = f(tree, jnp.asarray(PROMPT, jnp.int32),
                 jnp.asarray(PADDING, jnp.int32))
    _close(_same_on_both(ranks, "bert_mlm"), np.asarray(mlm), "mlm")
    _close(_same_on_both(ranks, "bert_nsp"), np.asarray(nsp), "nsp")

