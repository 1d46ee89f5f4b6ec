"""ServeEngine: bucketed, continuous-batching decode over a slotted KV
cache.

Counterpart of ``apex_tpu/serving/engine.py``. Every call runs at a
bucket's shape: active sequences pad up to the smallest batch bucket
that fits (with distinct free slots) and prompts right-pad up to a
prefill bucket. The JAX engine compiles one executable per bucket ahead
of time; PyTorch runs eagerly, so the port compiles nothing and has no
``compile_count`` (its counterpart, one CUDA graph captured per bucket,
is later work: the fill levels and finite flags already stay on the
device for it).

The steps reuse the model's own KV-cache semantics, each slot at its own
fill level:

- :meth:`ServeEngine.prefill` admits a bucket: the prompts run as one
  batch from fresh zero rows at the padded length S, each row's level
  rolls back to its true length (the pad positions stay resident but
  masked), the first token comes from each row's true last position,
  and the rows are quantized (int8 mode) and scattered into their
  slots.
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

Not ported yet (they raise ``NotImplementedError`` naming the slice, see
ROADMAP): a device ``mesh`` or tensor-parallel ``model_axis``, the
prefix cache, ``extract_kv_state`` (KV migration), the memory preflight
and OOM guard, and a preemption ``guard``.

    engine = ServeEngine(model, ServeConfig(cache_mode="int8"))
    completed, stats = engine.serve(synthetic_trace(32, seed=0))
"""

import dataclasses
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models import generation
from apex_tpu_torch.parallel import compression
from apex_tpu_torch.serving import kv_cache as kvc
from apex_tpu_torch.serving import robust



def _not_ported(what, slice_, item):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the {slice_} slice "
        f"(ROADMAP queue A item {item})")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs: the bucket ladders, the slot count, the cache mode,
    sampling, and the speculative draft model.

    ``batch_buckets`` is the decode ladder (active sequences pad up to
    the smallest bucket that fits); ``prefill_buckets`` the prompt-length
    ladder (prompts right-pad up to a bucket; the pad positions stay
    masked by the cache's absolute-position attention). ``draft_model``
    (a port ``GPTModel`` holding its weights, sharing the target's
    vocabulary) turns every decode call into one speculative round of
    ``num_draft_tokens`` proposals; greedy only (``temperature`` 0).
    ``model_axis``, ``preflight`` and ``prefix_cache`` name features of
    the JAX engine that are not ported yet: setting them raises."""

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
    num_draft_tokens: int = 4
    model_axis: Optional[str] = None
    preflight: bool = False
    prefix_cache: bool = False


class ServeEngine:
    """Prefill and decode over a slotted KV cache on the model's device.

    The engine owns the store; it knows nothing of requests (admission,
    eviction and latency live in
    :class:`~apex_tpu_torch.serving.scheduler.Scheduler`, which
    :meth:`serve` builds). Slot ids are host ints; a bucket is padded
    with caller-provided free slots (distinct ids)."""

    def __init__(self, model, config: ServeConfig = None, *, mesh=None):
        config = config or ServeConfig()
        if mesh is not None or config.model_axis is not None:
            raise _not_ported("serving over a device mesh or a "
                              "tensor-parallel model_axis",
                              "tensor-parallel serving", 5)
        if config.prefix_cache:
            raise _not_ported("prefix_cache", "prefix-cache serving", 5)
        if config.preflight:
            raise _not_ported("the memory preflight and OOM guard",
                              "telemetry", 7)
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
        self.model = model
        self.device = model.device
        self.config = dataclasses.replace(config, batch_buckets=bb,
                                          prefill_buckets=sb)
        self.max_len = limit
        self.spec = kvc.KVCacheSpec(model, config.num_slots,
                                    mode=config.cache_mode,
                                    block_size=config.block_size)
        self._store = self.spec.allocate()
        self.draft_spec = self._draft_store = None
        if self._spec_decode:
            self.draft_spec = kvc.KVCacheSpec(
                config.draft_model, config.num_slots, mode=config.cache_mode,
                block_size=config.block_size)
            self._draft_store = self.draft_spec.allocate()
        self._generator = None
        if config.temperature:  # seeded 0, as JAX's engine keys from 0
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(0)
        self._decode_calls = 0
        self.decode_retries_total = 0
        self._poison = None

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

    def kv_cache_bytes(self):
        return self.spec.total_bytes()

    def draft_kv_cache_bytes(self):
        return self.draft_spec.total_bytes() if self._spec_decode else 0

    def slot_lengths(self):
        """Host copy of the per-slot fill levels (one small fetch)."""
        return kvc.store_lengths(self._store).cpu().numpy()

    def extract_kv_state(self, slot_ids):
        raise _not_ported("extract_kv_state (KV migration)",
                          "serving fleet", 5)

    def poison_slot(self, slot, at_call=None):
        """Fault injection: make slot ``slot``'s logits NaN in decode call
        number ``at_call`` (the engine's lifetime decode-call counter,
        0-based; default the next call), once. The step then quarantines
        the slot on the device (its rows zeroed, the pad token sampled),
        as a real non-finite slot would be."""
        at = self._decode_calls if at_call is None else int(at_call)
        self._poison = (int(slot), at)

    def _poison_for(self, call):
        if self._poison is None or self._poison[1] != call:
            return -1
        slot, self._poison = self._poison[0], None
        return slot

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
        return self._put(np.asarray(ids, np.int64))

    def _put(self, array):
        """A host array on the engine's device. On the card it goes
        through pinned memory without blocking, so the step's only wait
        for the device stays the read of its sampled tokens."""
        t = torch.from_numpy(array)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sample(self, logits):
        cfg = self.config
        return generation.sample_logits(logits, self._generator,
                                        cfg.temperature, cfg.top_k,
                                        cfg.top_p)

    # -- the steps ---------------------------------------------------------

    def _prefill_one_model(self, model, spec, store, ids, tokens, true_len):
        """Prefill a bucket of prompts into ``ids`` of ``store`` for one
        model (target or draft): the rows from zero at the padded length,
        each row's level rolled back to its true length. Returns the
        logits at each row's true last position [b, vocab]."""
        b = tokens.shape[0]
        cache = generation.init_cache(model, b)
        pos = torch.arange(tokens.shape[1], device=self.device)[None, :]
        cache, logits = generation.prefill(model, cache, tokens, pos,
                                           full_logits=True)
        last = logits[torch.arange(b, device=self.device), true_len - 1]
        generation._set_cache_index(cache, true_len)
        spec.scatter_rows(store, ids, spec.quantize_rows(cache))
        return last

    @torch.no_grad()
    def prefill(self, slot_ids, prompts, *, pad_slot_ids=None):
        """Prefill ``prompts[i]`` (1-D int sequences) into
        ``slot_ids[i]`` and return the first generated token of each,
        ``np.ndarray [len(prompts)]``. Pads the call up to the smallest
        (batch, seq) bucket pair; with a draft model its cache is
        prefilled with the same tokens."""
        if len(slot_ids) != len(prompts):
            raise ValueError("slot_ids and prompts disagree")
        n = len(prompts)
        plens = [len(p) for p in prompts]
        if min(plens) < 1:
            raise ValueError("empty prompt")
        bbucket = self._pick_bucket(self.config.batch_buckets, n,
                                    "prefill batch")
        ids = self._padded_ids(slot_ids, pad_slot_ids, bbucket)
        sbucket = self._pick_bucket(self.config.prefill_buckets,
                                    max(plens), "prompt length")
        toks = np.full((bbucket, sbucket), self.config.pad_token_id,
                       np.int64)
        lens = np.ones((bbucket,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :plens[i]] = np.asarray(p, np.int64)
            lens[i] = plens[i]
        toks, lens = self._put(toks), self._put(lens)
        last = self._prefill_one_model(self.model, self.spec, self._store,
                                       ids, toks, lens)
        first = self._sample(last)
        if self._spec_decode:
            self._prefill_one_model(self.config.draft_model,
                                    self.draft_spec, self._draft_store, ids,
                                    toks, lens)
        return first.cpu().numpy()[:n]

    def _decode_fn(self, ids, tokens, poison):
        """One decode step over a slot bucket: gather the rows,
        dequantize on read, one forward with each row at its own level,
        requantize only the appended position, quarantine non-finite
        rows, scatter back, sample. Returns (tokens, finite) on the
        device."""
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
        return nxt, finite

    def _spec_decode_fn(self, ids, tokens, poison):
        """One speculative round over a slot bucket, each slot at its own
        level n (:func:`~apex_tpu_torch.models.generation.speculative_round`:
        k draft proposals plus the completion feed, one chunked target
        verification of ``[last, d_1..d_k]``), per-slot acceptance
        (no batch minimum), both caches rolled back to ``n + accepted +
        1``; int8 stores requantize exactly the ``k + 1``-position window.
        Non-finite verification logits (or the poisoned slot) zero the
        slot's rows in both stores and emit one pad token. Returns
        (emitted [b, k+1], counts [b], finite [b]) on the device."""
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
        return emit, counts, finite

    @torch.no_grad()
    def decode(self, slot_ids, tokens, *, pad_slot_ids=None, retries=0,
               backoff_s=0.05, backoff_cap_s=1.0):
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
        :class:`~apex_tpu_torch.serving.robust.DecodeFailedError`."""
        n = len(slot_ids)
        bbucket = self._pick_bucket(self.config.batch_buckets, n,
                                    "decode batch")
        ids = self._padded_ids(slot_ids, pad_slot_ids, bbucket)
        toks = np.zeros((bbucket,), np.int64)
        toks[:n] = np.asarray(tokens, np.int64)
        toks = self._put(toks)
        step_idx = self._decode_calls
        self._decode_calls += 1
        poison = self._poison_for(step_idx)
        step = self._spec_decode_fn if self._spec_decode else self._decode_fn
        for attempt in range(int(retries) + 1):
            try:
                out = step(ids, toks, poison)
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
                time.sleep(robust.retry_backoff_s(attempt, backoff_s,
                                                  backoff_cap_s))
        # one device-to-host copy a step: tokens and flags together
        if self._spec_decode:
            emit, counts, finite = out
            host = torch.cat([emit, counts[:, None], finite[:, None]],
                             dim=1).cpu().numpy()[:n]
            return host[:, :-2], host[:, -2], host[:, -1].astype(bool)
        nxt, finite = out
        host = torch.stack([nxt, finite.long()]).cpu().numpy()[:, :n]
        return host[0], host[1].astype(bool)

    def serve(self, requests, *, robust=None, guard=None, **kw):
        """Run a request list to completion through a fresh
        :class:`~apex_tpu_torch.serving.scheduler.Scheduler`; returns
        ``(completed, stats)``. ``robust`` (a
        :class:`~apex_tpu_torch.serving.robust.RobustConfig`) and
        ``guard`` (not ported yet: it raises) pass through to the
        scheduler."""
        from apex_tpu_torch.serving.scheduler import Scheduler

        sched = Scheduler(self, robust=robust, guard=guard)
        completed = sched.run(requests, **kw)
        return completed, sched.stats()
