"""ServeEngine: bucketed, continuous-batching decode over a slotted KV
cache, one CUDA graph per bucket.

Counterpart of ``apex_tpu/serving/engine.py``. Every call runs at a
bucket's shape: active sequences pad up to the smallest batch bucket
that fits (with distinct free slots) and prompts right-pad up to a
prefill bucket. Where the JAX engine compiles one executable per bucket
ahead of time, the port captures one CUDA graph per bucket when it is
built on the card: one for each (batch bucket, prefill bucket) prefill
and one for each batch bucket's decode call, so ``compile_count`` is
``len(batch_buckets) * len(prefill_buckets) + len(batch_buckets)`` and
stays flat under any traffic. The prefix cache and the draft model swap
a graph's body; they never add one. Every later call copies its host
inputs into the graph's static input buffer (one copy from pinned
memory), replays the graph and reads its one output. The graphs share
one memory pool, as only one replays at a time. A graph that fails to
capture or replay raises: nothing falls back to eager calls. On the CPU
nothing is captured (``compile_count`` 0) and the same step bodies run
eagerly.

The steps reuse the model's own KV-cache semantics, each slot at its own
fill level:

- :meth:`ServeEngine.prefill` admits a bucket: the prompts run as one
  batch from fresh zero rows at the padded length S, each row's level
  rolls back to its true length (the pad positions stay resident but
  masked), the first token comes from each row's true last position,
  and the rows are quantized (int8 mode) and scattered into their
  slots.
- With ``ServeConfig(prefix_cache=True)`` each prompt first consults
  the host-side :class:`~apex_tpu_torch.serving.prefix_cache.PrefixStore`:
  a hit seeds its row from the cached entry (the first ``cut`` positions
  copied into the bucket's seed buffer, a static input of the graph; a
  miss starts at level 0), the suffix alone picks the prefill bucket and
  runs at positions ``cut + arange(S)``, each row's level rolls to
  ``cut + n``, and every newly seen prompt's merged raw rows are copied
  to pinned host memory and cached. A seed carries only positions
  ``[0, cut)``: the rest are masked, so the port's entries differ from
  the JAX engine's only at masked positions.
- :meth:`ServeEngine.decode` gathers the bucket's rows, dequantizes
  them (int8), runs one decode step (each row at its own level through
  the per-row decode kernel), requantizes only the appended position,
  zeroes the rows of a slot whose logits went non-finite (it samples
  the pad token; the scheduler evicts it), and scatters the rows back.
  The scheduler reads the sampled tokens and finite flags once a step.
- With ``ServeConfig(draft_model=...)`` each decode call is one
  speculative round instead: the draft proposes ``num_draft_tokens``
  greedily (plus one completion feed), the target verifies the whole
  window in one chunked forward (the window kernel at each slot's own
  start), each slot emits its longest matching prefix plus one target
  token, and both caches roll back to ``n + accepted + 1``. Greedy
  only, token-identical to the plain engine.
- :meth:`ServeEngine.extract_kv_state` is the donor half of KV
  migration: one slot's rows as raw rows (int8 dequantized) in a host
  payload with a crc32 (:func:`kv_payload_crc`); a second engine
  inserts them into its prefix store and resumes with a one-token
  suffix.

Tensor-parallel serving: under a tp grid of ``tp`` ranks
(:func:`~apex_tpu_torch.transformer.parallel_state.initialize_model_parallel`)
every rank builds its own engine over its shard of the model, with a
:class:`ServeMesh` ``(data=1, tp)`` that names the grid, and runs the
same scheduler: one replica, JAX's ``(data=1, tp=m)`` mesh. The store
holds each rank's heads (:class:`~apex_tpu_torch.serving.kv_cache.
KVCacheSpec`), the step bodies are the tp = 1 bodies (the model reduces
its partial products and gathers its vocab-parallel logits, so every
rank samples the same tokens), seed rows arrive canonical and are cut
per rank, and :meth:`ServeEngine.extract_kv_state` gathers a slot's
rows over the ranks into canonical raw rows. A gloo collective runs on
the host, and no CUDA graph can capture it: at tp > 1 on the card the
capture raises (graphs at tp > 1 over NCCL, ROADMAP queue A item 5(d)),
so such an engine runs its bodies eagerly (``_capture = False``).

Telemetry and resilience, as the JAX engine's: the store's allocation
and the ladder's capture run under ``telemetry.memory.oom_guard``; each
graph capture is a compile of the :class:`~apex_tpu_torch.telemetry.
compile_watch.CompileWatcher` (``compile_count`` stays flat under any
traffic); ``preflight`` measures the decode peak (weights + store + the
ladder's graph pool) against capacity; every decode dispatch runs under
``resilience.guarded_call`` with the injection points
``faults.maybe_fail_decode`` / ``faults.poison_slot_for``; and the
``serve/kv_cache_bytes`` gauge, ``serve/aot_compiles`` counter and
``engine_start`` event land in the registry.

Not ported yet (it raises ``NotImplementedError`` naming the item, see
ROADMAP): a slot-sharded data axis (one replica a process: the fleet).

    engine = ServeEngine(model, ServeConfig(cache_mode="int8"))
    completed, stats = engine.serve(synthetic_trace(32, seed=0))
"""

import dataclasses
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models import generation
from apex_tpu_torch.models.params import rank_state_dict
from apex_tpu_torch.models.tp_split import split_params_for_tp
from apex_tpu_torch.parallel import compression
from apex_tpu_torch.serving import kv_cache as kvc
from apex_tpu_torch.serving import robust
from apex_tpu_torch.serving.prefix_cache import PrefixStore
from apex_tpu_torch.telemetry import compile_watch
from apex_tpu_torch.telemetry import memory as tmemory
from apex_tpu_torch.telemetry.registry import get_registry
from apex_tpu_torch.transformer import parallel_state


def _not_ported(what, slice_, item):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the {slice_} slice "
        f"(ROADMAP queue A item {item})")


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The port's counterpart of JAX's serving mesh: axis names and
    sizes over the ranks of :mod:`~apex_tpu_torch.transformer.
    parallel_state`'s grid, which place nothing themselves (each rank
    owns its card and its shard). :meth:`from_grid` gives the
    ``(data=1, tp)`` mesh of the bound grid."""

    axis_names: Tuple[str, ...] = ("data", "tp")
    shape: Tuple[int, ...] = (1, 1)

    @classmethod
    def from_grid(cls, data_axis="data", model_axis="tp"):
        return cls((data_axis, model_axis),
                   (1, parallel_state.get_tensor_model_parallel_world_size()))

    @property
    def size(self):
        return int(np.prod(self.shape))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs: the bucket ladders, the slot count, the cache mode,
    sampling, the speculative draft model and the prefix cache.

    ``batch_buckets`` is the decode ladder (active sequences pad up to
    the smallest bucket that fits); ``prefill_buckets`` the prompt-length
    ladder (prompts right-pad up to a bucket; the pad positions stay
    masked by the cache's absolute-position attention). ``draft_model``
    (a port ``GPTModel`` holding its weights, sharing the target's
    vocabulary) turns every decode call into one speculative round of
    ``num_draft_tokens`` proposals; greedy only (``temperature`` 0).
    ``prefix_cache`` keeps a host-side prefix store of up to
    ``prefix_max_entries`` prompts keyed by their first
    ``prefix_min_len`` tokens. ``data_axis`` and ``model_axis`` are the
    names of a tensor-parallel engine's :class:`ServeMesh` axes; the
    model axis must be ``"tp"``, as JAX's. ``draft_params`` (a tp = 1
    ``state_dict``) loads the draft through ``split_params_for_tp``, as
    the engine's ``params`` loads the target. ``preflight`` measures the
    decode peak (weights + store + the graph pool) at construction
    against the card's capacity (``$APEX_TPU_HBM_GB`` overrides it): a
    warning over budget, or ``telemetry.memory.MemoryBudgetError`` with
    ``preflight_strict``."""

    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    prefill_buckets: Tuple[int, ...] = (16, 32, 64)
    num_slots: int = 8
    cache_mode: str = "bf16"            # "bf16" | "int8"
    block_size: int = compression.BLOCK_SIZE
    temperature: float = 0.0            # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    draft_model: Any = dataclasses.field(default=None, repr=False,
                                         compare=False)
    draft_params: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)
    num_draft_tokens: int = 4
    data_axis: str = "data"
    model_axis: str = "tp"
    preflight: bool = True
    preflight_strict: bool = False
    prefix_cache: bool = False
    prefix_min_len: int = 4
    prefix_max_entries: int = 8


def kv_payload_crc(payload):
    """A migration payload's checksum recomputed from its contents (the
    check of :meth:`ServeEngine.extract_kv_state`'s ``"crc"``): the
    target rows, the draft rows when present and the fill length folded
    into one crc32, so a flipped byte anywhere, or a changed length,
    changes it."""
    crc = kvc.payload_checksum(payload["rows"])
    if payload.get("draft_rows") is not None:
        crc = kvc.payload_checksum(payload["draft_rows"], crc)
    return kvc.payload_checksum(
        [np.asarray(int(payload["length"]), np.int64)], crc)


class _Graph:
    """One captured step: the graph, its static int64 input buffer (the
    step's host inputs packed, :meth:`ServeEngine._layout`), its views by
    name, its static output and the kernel launches of one replay."""

    __slots__ = ("graph", "buffer", "views", "out", "launches")


class ServeEngine:
    """Prefill and decode over a slotted KV cache on the model's device.

    The engine owns the store; it knows nothing of requests (admission,
    eviction and latency live in
    :class:`~apex_tpu_torch.serving.scheduler.Scheduler`, which
    :meth:`serve` builds). Slot ids are host ints; a bucket is padded
    with caller-provided free slots (distinct ids). ``name`` scopes this
    engine's counters on a shared prefix store. ``params`` (a tp = 1
    ``state_dict``) is split by ``split_params_for_tp`` and this rank's
    shard loaded into ``model``; without it the model serves the weights
    it holds. At tp > 1 ``mesh`` is the grid's :class:`ServeMesh`."""

    # a CUDA engine captures its ladder; the card's reference runs build
    # a subclass that sets this False to time the same bodies eagerly
    _capture = True

    def __init__(self, model, config: ServeConfig = None, *, mesh=None,
                 name=None, params=None, registry=None, watcher=None):
        config = config or ServeConfig()
        tp = parallel_state.get_tensor_model_parallel_world_size()
        self.tp = tp
        self.mesh = mesh
        _check_mesh(mesh, config, tp)
        if tp > 1 and model.device.type == "cuda" and self._capture:
            raise NotImplementedError(
                f"CUDA graphs at tp={tp}: a gloo collective runs on the "
                f"host and no graph can capture it; graphs at tp > 1 over "
                f"NCCL come with ROADMAP queue A item 5(d), which needs a "
                f"machine with two cards to check. Build the engine with "
                f"_capture = False to run its bodies eagerly")
        if not config.batch_buckets or not config.prefill_buckets:
            raise ValueError("empty bucket ladder")
        bb = tuple(sorted(set(int(b) for b in config.batch_buckets)))
        sb = tuple(sorted(set(int(s) for s in config.prefill_buckets)))
        if bb[-1] > config.num_slots:
            raise ValueError(
                f"largest batch bucket ({bb[-1]}) exceeds num_slots "
                f"({config.num_slots}): a bucket gathers distinct slots")
        limit = model.config.max_position_embeddings
        if sb[-1] > limit:
            raise ValueError(
                f"largest prefill bucket ({sb[-1]}) exceeds "
                f"max_position_embeddings ({limit})")
        self._spec_decode = config.draft_model is not None
        if self._spec_decode:
            draft = config.draft_model
            if draft.config.vocab_size != model.config.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft.config.vocab_size}) != target "
                    f"vocab ({model.config.vocab_size}): the models must "
                    f"share a tokenizer")
            if draft.device != model.device:
                raise ValueError(f"draft model on {draft.device}, target "
                                 f"on {model.device}")
            if config.temperature:
                raise ValueError(
                    "speculative serving is greedy-only (temperature must "
                    "be 0.0): verification proves token-exactness against "
                    "the target's argmax, which sampling breaks")
            if config.num_draft_tokens < 1:
                raise ValueError(f"num_draft_tokens "
                                 f"({config.num_draft_tokens}) must be >= 1")
            limit = min(limit, draft.config.max_position_embeddings)
            if sb[-1] > limit:
                raise ValueError(
                    f"largest prefill bucket ({sb[-1]}) exceeds the draft "
                    f"model's position budget ({limit})")
        for m, p in ((model, params), (config.draft_model,
                                       config.draft_params)):
            if p is not None:
                m.load_state_dict(rank_state_dict(
                    split_params_for_tp(m.config, p, tp),
                    parallel_state.get_tensor_model_parallel_rank()))
        self.model = model
        self.device = model.device
        self.config = dataclasses.replace(config, batch_buckets=bb,
                                          prefill_buckets=sb)
        self.name = name
        self._scope = name or "engine"
        self._prefix = bool(config.prefix_cache)
        self.prefix_store = PrefixStore(
            max_entries=config.prefix_max_entries,
            min_len=config.prefix_min_len) if self._prefix else None
        self.last_prefill_hits = []
        self.max_len = limit
        self._registry = registry
        self._watcher = watcher if watcher is not None \
            else compile_watch.get_watcher()
        self.spec = kvc.KVCacheSpec(model, config.num_slots,
                                    mode=config.cache_mode,
                                    block_size=config.block_size)
        self.draft_spec = self._draft_store = None
        # the store (the serving memory cost) allocated under the OOM
        # post-mortem handler
        labels = {"params": list(model.parameters())}
        with tmemory.oom_guard(registry=registry, labels=labels):
            self._store = self.spec.allocate()
            if self._spec_decode:
                self.draft_spec = kvc.KVCacheSpec(
                    config.draft_model, config.num_slots,
                    mode=config.cache_mode, block_size=config.block_size)
                self._draft_store = self.draft_spec.allocate()
        # the seeded prefill's buffers, one per batch bucket and model:
        # static inputs of its graphs, shared by the bucket's seq buckets
        self._seeds = {}
        self._staging = None
        if self._prefix:
            for b in bb:
                self._seeds[b] = tuple(
                    s.seed_buffer(b) if s is not None else None
                    for s in (self.spec, self.draft_spec))
            # one row of each seed buffer: where a hit's positions land
            # on the card before their strided copy into the bucket
            self._staging = tuple(
                s.seed_buffer(1)[:, :, :, 0] if s is not None else None
                for s in (self.spec, self.draft_spec))
        self._generator = None
        if config.temperature:  # seeded 0, as JAX's engine keys from 0
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(0)
        self._decode_calls = 0
        self.decode_retries_total = 0
        self._graphs = {}
        self.graph_seconds = 0.0
        self.graph_pool = None
        self.graph_pool_bytes = 0
        if self.device.type == "cuda" and self._capture:
            with tmemory.oom_guard(registry=registry,
                                   labels=self.census_labels()):
                self._capture_ladder()
        self.memory_report = None
        if config.preflight:
            self.memory_report = self._preflight()
        reg = self._reg()
        if reg.enabled:
            reg.gauge("serve/kv_cache_bytes").set(self.kv_cache_bytes())
            reg.counter("serve/aot_compiles").inc(self.compile_count)
            reg.event("serve", "engine_start",
                      engine=name,
                      batch_buckets=list(self.config.batch_buckets),
                      prefill_buckets=list(self.config.prefill_buckets),
                      num_slots=config.num_slots,
                      cache_dtype=self.spec.cache_dtype_name(),
                      kv_cache_bytes=self.kv_cache_bytes(),
                      compile_count=self.compile_count,
                      speculative=self._spec_decode,
                      num_draft_tokens=(config.num_draft_tokens
                                        if self._spec_decode else None),
                      draft_kv_cache_bytes=(self.draft_kv_cache_bytes()
                                            if self._spec_decode
                                            else None),
                      prefix_cache=self._prefix,
                      aot_compile_seconds=round(self.graph_seconds, 4))

    def _reg(self):
        return self._registry or get_registry()

    def weight_bytes(self):
        """Bytes of the target's (and the draft's) parameters and
        buffers."""
        models = [self.model] + ([self.config.draft_model]
                                 if self._spec_decode else [])
        return int(sum(t.numel() * t.element_size() for m in models
                       for t in list(m.parameters()) + list(m.buffers())))

    def _preflight(self):
        """The decode step's memory report: its peak is the weights, the
        stores and the ladder's graph pool (every step's temporaries live
        in the pool, measured at capture), against the card's capacity.
        Over budget it warns, or raises ``MemoryBudgetError`` with
        ``preflight_strict`` (JAX's ``headroom_frac < 0`` rule)."""
        resident = self.weight_bytes() + self.kv_cache_bytes() + \
            self.draft_kv_cache_bytes()
        report = tmemory.make_report(
            "serve/decode", peak_bytes=resident + self.graph_pool_bytes,
            argument_bytes=resident, temp_bytes=self.graph_pool_bytes,
            device=self.device)
        tmemory.record_report(report, registry=self._registry)
        return tmemory.judge(
            report, strict=self.config.preflight_strict,
            registry=self._registry,
            what="the serve decode step (shrink num_slots, the bucket "
                 "ladder, or switch cache_mode='int8')")

    # -- properties --------------------------------------------------------

    @property
    def spec_enabled(self):
        """True when decode calls run the speculative round (several
        tokens a call: the scheduler branches on this)."""
        return self._spec_decode

    @property
    def decode_headroom(self):
        """Cache positions a decode call may write beyond the emitted
        tokens: the speculative window overshoots by up to
        ``num_draft_tokens``, so admission keeps ``prompt + max_new +
        headroom`` inside the position budget."""
        return self.config.num_draft_tokens if self._spec_decode else 0

    @property
    def compile_count(self):
        """CUDA graphs captured at construction: the ladder's size on the
        card (flat under any traffic), 0 on the CPU."""
        return len(self._graphs)

    def ladder(self):
        """The bucket ladder's keys: ``{"decode": (b, ...), "prefill":
        ((b, s), ...)}``, one graph each on the card (the JAX engine's
        ``_decode_exec`` and ``_prefill_exec`` keys)."""
        cfg = self.config
        return {"decode": cfg.batch_buckets,
                "prefill": tuple((b, s) for b in cfg.batch_buckets
                                 for s in cfg.prefill_buckets)}

    @property
    def prefix_hits(self):
        """This engine's hits (its scope's, on a possibly shared
        store)."""
        return self.prefix_store.scope_stats(self._scope)["hits"] \
            if self._prefix else 0

    @property
    def prefix_lookups(self):
        return self.prefix_store.scope_stats(self._scope)["lookups"] \
            if self._prefix else 0

    @property
    def prefix_hit_tokens(self):
        return self.prefix_store.scope_stats(self._scope)["hit_tokens"] \
            if self._prefix else 0

    def adopt_prefix_store(self, store):
        """Swap in a shared :class:`PrefixStore` (host only: the graphs do
        not change); this engine's counters stay apart on it under its
        ``name``. Returns the store."""
        if not self._prefix:
            raise ValueError(
                "engine was built without prefix_cache=True: there is no "
                "seeded prefill to serve a shared store")
        self.prefix_store = store
        return store

    def kv_cache_bytes(self):
        return self.spec.total_bytes()

    def census_labels(self):
        """OOM post-mortem attribution (``live_buffer_census`` matches
        storages): the weights and the KV stores, the draft model's too
        on a speculative engine."""
        labels = {"params": list(self.model.parameters()),
                  "kv_cache": self._store}
        if self._spec_decode:
            labels["draft_params"] = list(
                self.config.draft_model.parameters())
            labels["kv_cache_draft"] = self._draft_store
        return labels

    def draft_kv_cache_bytes(self):
        return self.draft_spec.total_bytes() if self._spec_decode else 0

    def slot_lengths(self):
        """Host copy of the per-slot fill levels (one small fetch)."""
        return kvc.store_lengths(self._store).cpu().numpy()

    def seed_row_template(self, which="target"):
        """The canonical raw host row layout this engine seeds slots from
        (the layout a migration payload's rows must have, the same at any
        tp), or None for the draft of a plain engine."""
        spec = self.spec if which == "target" else self.draft_spec
        return spec.host_zero_row() if spec is not None else None

    @torch.no_grad()
    def extract_kv_state(self, slot_ids):
        """Each slot's KV state as a checksummed host payload, the donor
        half of KV migration: the slot's store rows gathered on the
        device (at tp > 1 also over the ranks, into JAX's global view:
        every rank calls this with the same slots), made canonical and
        raw (int8 blocks dequantized, #15 on the card,
        :meth:`KVCacheSpec.consolidate_host_rows`), copied to the host,
        the draft's the same way on a speculative engine, and the rows
        and fill length folded into a crc32 (:func:`kv_payload_crc`).

        Returns ``{slot: {"slot", "length", "tp", "cache_mode", "rows",
        "draft_rows", "crc"}}``. Call after
        ``Scheduler.extract_unfinished`` (releasing a slot only forgets
        its id: the rows stay) and before anything prefills into the
        freed slots."""
        lengths = self.slot_lengths()
        out = {}
        for slot in slot_ids:
            slot = int(slot)
            idx = torch.tensor([slot], dtype=torch.long, device=self.device)
            rows = [_to_host(spec.consolidate_host_rows(
                        spec.global_rows(spec.gather_rows(store, idx)),
                        tp=self.tp), spec.num_layers)
                    if spec is not None else None
                    for spec, store in ((self.spec, self._store),
                                        (self.draft_spec,
                                         self._draft_store))]
            payload = {"slot": slot, "length": int(lengths[slot]),
                       "tp": self.tp,
                       "cache_mode": self.config.cache_mode,
                       "rows": rows[0], "draft_rows": rows[1]}
            payload["crc"] = kv_payload_crc(payload)
            out[slot] = payload
        return out

    def poison_slot(self, slot, at_call=None):
        """Fault injection: make slot ``slot``'s logits NaN in decode call
        number ``at_call`` (the engine's lifetime decode-call counter,
        0-based; default the next call), once, through
        ``faults.arm_slot_nan`` (read by ``faults.poison_slot_for`` at
        each dispatch, as the JAX engine reads it). The step then
        quarantines the slot on the device (its rows zeroed, the pad
        token sampled), as a real non-finite slot would be."""
        from apex_tpu_torch.resilience import faults

        at = self._decode_calls if at_call is None else int(at_call)
        faults.arm_slot_nan(int(slot), at)

    # -- helpers -----------------------------------------------------------

    def _pick_bucket(self, ladder, n, what):
        for b in ladder:
            if n <= b:
                return b
        raise ValueError(f"{what} ({n}) exceeds the largest bucket "
                         f"({ladder[-1]})")

    def _padded_ids(self, slot_ids, pad_slot_ids, bucket):
        ids = list(int(i) for i in slot_ids)
        need = bucket - len(ids)
        if need:
            pads = [int(i) for i in (pad_slot_ids or ())
                    if int(i) not in ids][:need]
            if len(pads) < need:
                raise ValueError(
                    f"bucket {bucket} needs {need} pad slot(s) but only "
                    f"{len(pads)} free id(s) were provided: pad ids must "
                    f"be distinct unused slots (a duplicate scatter would "
                    f"collide)")
            ids += pads
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate slot ids in {ids}")
        if min(ids) < 0 or max(ids) >= self.config.num_slots:
            raise ValueError(f"slot ids {ids} outside [0, "
                             f"{self.config.num_slots})")
        return np.asarray(ids, np.int64)

    def _sample(self, logits):
        cfg = self.config
        return generation.sample_logits(logits, self._generator,
                                        cfg.temperature, cfg.top_k,
                                        cfg.top_p)

    # -- the ladder --------------------------------------------------------

    def _layout(self, key):
        """(name, shape) of a step's int64 inputs, in their order in the
        packed input buffer."""
        b = key[1]
        if key[0] == "decode":
            return (("ids", (b,)), ("tokens", (b,)), ("poison", (1,)))
        return (("ids", (b,)), ("tokens", (b, key[2])), ("lens", (b,)),
                ("starts", (b,)))

    def _body(self, key):
        return self._decode_body if key[0] == "decode" else \
            lambda **v: self._prefill_body(key[1], **v)

    def _views(self, key, buf):
        out, at = {}, 0
        for name, shape in self._layout(key):
            n = int(np.prod(shape))
            out[name] = buf[at:at + n].view(shape)
            at += n
        return out

    def _pack(self, key, host):
        return np.concatenate([np.asarray(host[name], np.int64).reshape(-1)
                               for name, _ in self._layout(key)])

    def _capture_ladder(self):
        """Capture one CUDA graph for each ladder entry, into one shared
        memory pool: each body runs once eagerly on a side stream first
        (the kernels' builds, cuBLAS's handles, the split counters), then
        is captured with its launch counts recorded. Each capture is a
        compile of the compile watcher (``record_aot``, under this
        engine's ``name``). The warm-up calls write the store, so the
        stores and seed buffers are zeroed after."""
        self.graph_pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        keys = [("decode", b) for b in self.config.batch_buckets] + [
            ("prefill", b, s) for b, s in self.ladder()["prefill"]]
        aot = f"{self.name}/serve" if self.name else "serve"
        decode_tag = "spec_decode" if self._spec_decode else "decode"
        prefill_tag = "seeded_prefill" if self._prefix else "prefill"
        with torch.no_grad():
            for key in keys:
                t1 = time.perf_counter()
                self._graphs[key] = self._capture_one(key)
                tag = (f"{decode_tag}_b{key[1]}" if key[0] == "decode"
                       else f"{prefill_tag}_b{key[1]}_s{key[2]}")
                self._watcher.record_aot(
                    f"{aot}/{self.config.cache_mode}/{tag}",
                    [shape for _, shape in self._layout(key)],
                    seconds=time.perf_counter() - t1)
        self.graph_pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(
                self.graph_pool))
        for store in (self._store, self._draft_store):
            for leaf in kvc._leaves(store or {}):
                leaf.zero_()
        for bufs in self._seeds.values():
            for buf in bufs:
                if buf is not None:
                    buf.zero_()
        if self._generator is not None:
            self._generator.manual_seed(0)
        torch.cuda.synchronize(self.device)
        self.graph_seconds = time.perf_counter() - t0

    def _capture_one(self, key):
        b = key[1]
        warm = {"ids": np.arange(b), "tokens": np.zeros(0), "poison": [-1],
                "lens": np.ones(b), "starts": np.zeros(b)}
        g = _Graph()
        sizes = sum(int(np.prod(shape)) for _, shape in self._layout(key))
        g.buffer = torch.zeros(sizes, dtype=torch.long, device=self.device)
        g.views = self._views(key, g.buffer)
        for name, _ in self._layout(key):
            if name != "tokens":
                g.views[name].copy_(torch.as_tensor(
                    np.asarray(warm[name], np.int64)))
        body = self._body(key)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body(**g.views)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        g.graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            if not hasattr(g.graph, "register_generator_state"):
                raise RuntimeError(
                    "sampling inside a CUDA graph needs "
                    "CUDAGraph.register_generator_state, which this torch "
                    "does not have")
            g.graph.register_generator_state(self._generator)
        before = registry.launches()
        try:
            with torch.cuda.graph(g.graph, pool=self.graph_pool):
                g.out = body(**g.views)
        finally:
            after = registry.launches()
            registry.restore(before)
        g.launches = {k: n - before.get(k, 0) for k, n in after.items()
                      if n != before.get(k, 0)}
        return g

    def _run(self, key, host):
        """One step: replay its graph with ``host`` (name -> host ints)
        as the inputs, or on an engine without graphs run its body on
        freshly placed inputs. Returns the step's output on the device
        (a graph's static output: read it before the next call)."""
        packed = torch.from_numpy(self._pack(key, host))
        if not self._graphs:
            if self.device.type == "cuda":
                packed = packed.pin_memory().to(self.device,
                                                non_blocking=True)
            return self._body(key)(**self._views(key, packed))
        g = self._graphs[key]
        g.buffer.copy_(packed.pin_memory(), non_blocking=True)
        g.graph.replay()
        registry.replayed(g.launches)
        return g.out

    # -- the steps ---------------------------------------------------------

    def _prefill_one_model(self, model, spec, store, seed, ids, tokens,
                           lens, starts):
        """Prefill a bucket of prompts into ``ids`` of ``store`` for one
        model (target or draft) and return the logits at each row's true
        last position [b, vocab]. Without a seed buffer the rows start
        from zeros at positions ``arange(S)``; with one (the prefix
        cache) each row starts at its level ``starts`` over the seeded
        rows, the suffix at ``starts + arange(S)``, written in place into
        the buffer. Each row's level then rolls to ``starts + lens``."""
        b, s = tokens.shape
        steps = torch.arange(s, device=tokens.device)[None, :]
        if seed is None:
            cache = generation.init_cache(model, b)
            pos, end = steps, lens
        else:
            cache = spec.seed_cache(seed, starts.to(torch.int32))
            pos, end = starts[:, None] + steps, starts + lens
        # the true last positions picked before the vocab gather
        logits = model(tokens, pos, cache)
        last = generation._full_vocab(
            logits[torch.arange(b, device=tokens.device), lens - 1])
        generation._set_cache_index(cache, end)
        spec.scatter_rows(store, ids, spec.quantize_rows(cache))
        return last

    def _prefill_body(self, b, ids, tokens, lens, starts=None):
        seeds = self._seeds.get(b, (None, None))
        last = self._prefill_one_model(self.model, self.spec, self._store,
                                       seeds[0], ids, tokens, lens, starts)
        first = self._sample(last)
        if self._spec_decode:
            self._prefill_one_model(self.config.draft_model,
                                    self.draft_spec, self._draft_store,
                                    seeds[1], ids, tokens, lens, starts)
        return first

    @torch.no_grad()
    def prefill(self, slot_ids, prompts, *, pad_slot_ids=None):
        """Prefill ``prompts[i]`` (1-D int sequences) into
        ``slot_ids[i]`` and return the first generated token of each,
        ``np.ndarray [len(prompts)]``. Pads the call up to the smallest
        (batch, seq) bucket pair; with a draft model its cache is
        prefilled with the same tokens.

        With the prefix cache each prompt is looked up first: a hit
        seeds its row from the cached entry and only the suffix picks
        the seq bucket; every newly seen prompt's merged rows are
        cached. ``last_prefill_hits`` holds each prompt's cut (0 = a
        miss) for the scheduler's accounting."""
        if len(slot_ids) != len(prompts):
            raise ValueError("slot_ids and prompts disagree")
        n = len(prompts)
        plens = [len(p) for p in prompts]
        if min(plens) < 1:
            raise ValueError("empty prompt")
        bbucket = self._pick_bucket(self.config.batch_buckets, n,
                                    "prefill batch")
        ids = self._padded_ids(slot_ids, pad_slot_ids, bbucket)
        cuts, lookups = [0] * n, [(0, None)] * n
        if self._prefix:
            lookups = [self.prefix_store.lookup(p, scope=self._scope)
                       for p in prompts]
            cuts = [c for c, _ in lookups]
        sbucket = self._pick_bucket(
            self.config.prefill_buckets,
            max(p - c for p, c in zip(plens, cuts)),
            "prompt suffix length" if self._prefix else "prompt length")
        toks = np.full((bbucket, sbucket), self.config.pad_token_id,
                       np.int64)
        lens = np.ones((bbucket,), np.int64)
        starts = np.zeros((bbucket,), np.int64)
        for i, p in enumerate(prompts):
            suffix = np.asarray(p, np.int64)[cuts[i]:]
            toks[i, :suffix.shape[0]] = suffix
            lens[i], starts[i] = suffix.shape[0], cuts[i]
        host = {"ids": ids, "tokens": toks, "lens": lens, "starts": starts}
        if self._prefix:
            self._seed_hits(bbucket, lookups)
        first = self._run(("prefill", bbucket, sbucket), host)
        first = first.cpu().numpy()[:n]
        self.last_prefill_hits = cuts
        if self._prefix:
            self._record_prefix(bbucket, prompts, plens)
        return first

    def _seed_hits(self, b, lookups):
        """Copy each hit's first ``cut`` positions into the bucket's seed
        buffers (a miss needs nothing: its level 0 masks every position).
        Returns the bytes copied."""
        hits = [(i, c, e) for i, (c, e) in enumerate(lookups) if c]
        copied = 0
        for spec, buf, staging, attr in (
                (self.spec, self._seeds[b][0], self._staging[0], "rows"),
                (self.draft_spec, self._seeds[b][1], self._staging[1],
                 "draft_rows")):
            if buf is None:
                continue
            for i, cut, entry in hits:
                copied += spec.seed_rows(buf, i, getattr(entry, attr), cut,
                                         staging)
        return copied

    def _record_prefix(self, b, prompts, plens):
        """Cache every prompt of the call the store does not cover yet:
        host copies of its raw merged rows (the full ``max_len`` positions,
        full precision) taken from the seed buffers without blocking.
        Returns the bytes copied."""
        store = self.prefix_store
        inserts = [i for i, p in enumerate(prompts)
                   if plens[i] > store.min_len and not store.covers(p)]
        if not inserts:
            return 0
        levels = [plens[i] for i in inserts]
        target, draft = self._seeds[b]
        rows = self.spec.host_raw_rows(target, inserts, levels)
        drows = self.draft_spec.host_raw_rows(draft, inserts, levels) \
            if draft is not None else [None] * len(inserts)
        for i, r, d in zip(inserts, rows, drows):
            store.insert(prompts[i], r, d, scope=self._scope)
        return sum(kvc.tree_bytes(r) + (kvc.tree_bytes(d) if d else 0)
                   for r, d in zip(rows, drows))

    def _decode_body(self, ids, tokens, poison):
        return self._spec_decode_fn(ids, tokens, poison) \
            if self._spec_decode else self._decode_fn(ids, tokens, poison)

    def _decode_fn(self, ids, tokens, poison):
        """One decode step over a slot bucket: gather the rows,
        dequantize on read, one forward with each row at its own level,
        requantize only the appended position, quarantine non-finite
        rows, scatter back, sample. Returns [2, b] int64 on the device:
        the tokens and the finite flags."""
        spec = self.spec
        rows = spec.gather_rows(self._store, ids)
        cache = spec.materialize_rows(rows)
        lengths = cache.lengths.clone()
        _, logits = generation.decode_step(self.model, cache, tokens[:, None],
                                           lengths[:, None].long())
        logits = torch.where((ids == poison)[:, None],
                             torch.full((), float("nan"),
                                        device=self.device), logits)
        finite = torch.isfinite(logits).all(dim=-1)
        # a non-finite row samples from zeros (a draw from NaN logits
        # raises) and emits the pad token
        safe = torch.where(finite[:, None], logits, 0.0)
        nxt = torch.where(finite, self._sample(safe),
                          self.config.pad_token_id)
        rows = spec.keep_rows(spec.update_rows_at(rows, cache, lengths),
                              finite)
        spec.scatter_rows(self._store, ids, rows)
        return torch.stack([nxt, finite.long()])

    def _spec_decode_fn(self, ids, tokens, poison):
        """One speculative round over a slot bucket, each slot at its own
        level n (:func:`~apex_tpu_torch.models.generation.speculative_round`:
        k draft proposals plus the completion feed, one chunked target
        verification of ``[last, d_1..d_k]``), per-slot acceptance
        (no batch minimum), both caches rolled back to ``n + accepted +
        1``; int8 stores requantize exactly the ``k + 1``-position window.
        Non-finite verification logits (or the poisoned slot) zero the
        slot's rows in both stores and emit one pad token. Returns [b,
        k + 3] int64 on the device: the emitted tokens [b, k+1], the
        counts and the finite flags."""
        k = int(self.config.num_draft_tokens)
        rows = self.spec.gather_rows(self._store, ids)
        drows = self.draft_spec.gather_rows(self._draft_store, ids)
        tcache = self.spec.materialize_rows(rows)
        dcache = self.draft_spec.materialize_rows(drows)
        n = tcache.lengths.clone()
        generation._set_cache_index(dcache, n)
        d, v, logits, accepted = generation.speculative_round(
            self.model, self.config.draft_model, tcache, dcache, tokens, n, k)
        logits = torch.where((ids == poison)[:, None, None],
                             torch.full((), float("nan"),
                                        device=self.device), logits)
        finite = torch.isfinite(logits).flatten(1).all(dim=-1)
        steps = torch.arange(k + 1, device=self.device)
        emit = torch.where(steps[None, :] == accepted[:, None],
                           v.gather(1, accepted[:, None]),
                           torch.cat([d, d[:, -1:]], dim=1))
        emit = torch.where(finite[:, None], emit, self.config.pad_token_id)
        counts = torch.where(finite, accepted + 1, 1)
        generation._set_cache_index(tcache, n + counts)
        generation._set_cache_index(dcache, n + counts)
        for spec, store, r, cache in (
                (self.spec, self._store, rows, tcache),
                (self.draft_spec, self._draft_store, drows, dcache)):
            r = spec.keep_rows(spec.update_rows_span(r, cache, n, k + 1),
                               finite)
            spec.scatter_rows(store, ids, r)
        return torch.cat([emit, counts[:, None], finite[:, None].long()],
                         dim=1)

    @torch.no_grad()
    def decode(self, slot_ids, tokens, *, pad_slot_ids=None, retries=0,
               backoff_s=0.05, backoff_cap_s=1.0, guarded=True):
        """One decode step for the active ``slot_ids`` fed their last
        ``tokens``; returns ``(next_tokens, finite)``, each
        ``np.ndarray [len(slot_ids)]`` (``finite[i]`` False iff slot i's
        logits went non-finite: its rows are already zeroed). A
        speculative engine runs one round instead and returns
        ``(emitted [n, k+1], counts [n], finite [n])``: slot i's verified
        tokens are ``emitted[i, :counts[i]]``. ``retries`` re-runs the
        step after a transient failure
        (:func:`~apex_tpu_torch.serving.robust.is_retryable_decode_error`)
        with capped exponential backoff; past the budget it raises
        :class:`~apex_tpu_torch.serving.robust.DecodeFailedError`.

        Dispatch runs under ``resilience.guarded_call`` (``guarded=False``
        opts out): an out-of-memory error mid-traffic writes the memory
        post-mortem, its census labeled with the KV stores and weights,
        and surfaces as ``HBMExhaustedError``. The injection points
        (``faults.maybe_fail_decode`` before each attempt,
        ``faults.poison_slot_for`` once a call) are keyed on the
        engine's lifetime decode-call counter. Nothing records inside
        the graph: the host reads one output after the replay."""
        from apex_tpu_torch import resilience
        from apex_tpu_torch.resilience import faults

        n = len(slot_ids)
        bbucket = self._pick_bucket(self.config.batch_buckets, n,
                                    "decode batch")
        ids = self._padded_ids(slot_ids, pad_slot_ids, bbucket)
        toks = np.zeros((bbucket,), np.int64)
        toks[:n] = np.asarray(tokens, np.int64)
        step_idx = self._decode_calls
        self._decode_calls += 1
        host = {"ids": ids, "tokens": toks,
                "poison": [faults.poison_slot_for(step_idx)]}

        def dispatch():
            # one device-to-host copy a step: tokens and flags together
            return self._run(("decode", bbucket), host).cpu().numpy()

        for attempt in range(int(retries) + 1):
            try:
                faults.maybe_fail_decode(step_idx)
                if guarded:
                    out = resilience.guarded_call(
                        dispatch, registry=self._registry,
                        labels=self.census_labels())
                else:
                    out = dispatch()
                break
            except Exception as e:  # noqa: BLE001 (classified below)
                if not robust.is_retryable_decode_error(e):
                    raise
                if attempt >= int(retries):
                    raise robust.DecodeFailedError(
                        f"decode call {step_idx} (bucket {bbucket}, slots "
                        f"{ids[:n].tolist()}) failed {attempt + 1} time(s); "
                        f"retry budget ({retries}) exhausted: {e}",
                        attempts=attempt + 1, last_error=e) from e
                self.decode_retries_total += 1
                reg = self._reg()
                reg.counter("serve/decode_retries").inc()
                reg.event("serve", "decode_retry", step=step_idx,
                          attempt=attempt, error=type(e).__name__)
                time.sleep(robust.retry_backoff_s(attempt, backoff_s,
                                                  backoff_cap_s))
        if self._spec_decode:
            host = out[:n]
            return host[:, :-2], host[:, -2], host[:, -1].astype(bool)
        return out[0, :n], out[1, :n].astype(bool)

    def serve(self, requests, *, robust=None, guard=None, **kw):
        """Run a request list to completion through a fresh
        :class:`~apex_tpu_torch.serving.scheduler.Scheduler`; returns
        ``(completed, stats)``. ``robust`` (a
        :class:`~apex_tpu_torch.serving.robust.RobustConfig`) and
        ``guard`` (a :class:`~apex_tpu_torch.resilience.PreemptionGuard`
        whose signal starts the drain) pass through to the scheduler."""
        from apex_tpu_torch.serving.scheduler import Scheduler

        sched = Scheduler(self, robust=robust, guard=guard,
                          registry=self._registry)
        completed = sched.run(requests, **kw)
        return completed, sched.stats()


def _check_mesh(mesh, config, tp):
    """JAX's validation of the serving mesh (``engine.py:167-200``, the
    same messages), for the port's :class:`ServeMesh`."""
    if mesh is not None and not isinstance(mesh, ServeMesh):
        raise TypeError(f"mesh must be a ServeMesh (axis names and sizes "
                        f"over the tp grid), got {type(mesh).__name__}")
    if tp > 1:
        if mesh is None:
            raise ValueError(
                f"tensor parallel serving (tp={tp}) needs a (data, model) "
                f"mesh — pass mesh=ServeMesh(('{config.data_axis}', "
                f"'{config.model_axis}'), (1, {tp}))")
        if config.model_axis != "tp":
            raise ValueError(
                f"model_axis ({config.model_axis!r}) must be 'tp': the "
                f"model's collectives are hardwired to that axis name, and "
                f"an unbound axis would silently skip every psum (axis "
                f"size 1) instead of failing")
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        if sizes.get(config.model_axis) != tp:
            raise ValueError(
                f"mesh axis {config.model_axis!r} has size "
                f"{sizes.get(config.model_axis)} but parallel_state says "
                f"tp={tp} — the mesh must match the process-group layout "
                f"the model was built under")
        if sizes.get(config.data_axis, 1) != 1:
            raise ValueError(
                f"a TP-sharded engine serves one replica: the "
                f"{config.data_axis!r} axis must have size 1 (got "
                f"{sizes.get(config.data_axis)}) — scale out with fleet "
                f"replicas, not a wide data axis")
    elif mesh is not None and mesh.size > 1:
        raise _not_ported(
            f"serving one replica over a {mesh.size}-device slot-sharded "
            f"data axis (in PyTorch, one replica a process: the fleet)",
            "fleet", "5(c)")


def _to_host(rows, num_layers):
    """Raw rows on the card copied to the host: the K/V leaves stacked on
    the card and fetched in one copy, each leaf a view of it."""
    kv = torch.stack(rows["keys"] + rows["values"]).cpu()
    return {"keys": list(kv[:num_layers]), "values": list(kv[num_layers:]),
            "lengths": rows["lengths"].cpu()}
