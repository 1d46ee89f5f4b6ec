"""Host-side continuous batching: admit, decode, evict, and survive.

Counterpart of ``apex_tpu/serving/scheduler.py``. The scheduler is plain
Python over numpy: it owns the request queue and the slot map, and the
only device work it starts is calls into the engine's prefill and
decode (it reads the sampled tokens once a step).

Time has two faces here. *Arrivals* are virtual: ``Request.arrival`` is
measured in decode ticks (one tick per scheduler step), so a trace is
deterministic: the same seed yields the same admission schedule and the
same bucket sequence on every run, whatever the host's speed.
*Latencies* and *deadlines* are wall-clock: TTFT runs from the moment a
request became eligible (arrival tick reached) to its first sampled
token landing on the host, so queueing for a slot counts; with the
engine's prefix cache it is also split into hits and misses
(``engine.last_prefill_hits``).

Fault tolerance (:mod:`apex_tpu_torch.serving.robust` holds the policy):
a bounded pending queue with reject-newest or shed-oldest shedding; TTFT
and total-latency deadlines checked each tick (status
``deadline_exceeded``); per-slot quarantine of a sequence whose logits
went non-finite (status ``poisoned``, its KV rows already zeroed on the
device), escalating to
:class:`~apex_tpu_torch.serving.robust.NonFiniteError` when every slot
of a batch goes non-finite at once; decode retries inside the engine,
past which only the implicated requests fail (status ``failed``); and a
graceful :meth:`Scheduler.drain`. :meth:`Scheduler.extract_unfinished`
takes unfinished requests out for migration to another engine.

Tensor-parallel serving runs the same scheduler on every rank of the
tp group, each over its own rank's engine. Admission is by ticks, so
the ranks agree on it; what a rank's own clock decides (expiry, the
drain and its deadline) is decided on tp rank 0 and broadcast over the
tp group once a step, since a rank that expired a request another kept
would hang the next collective; at the end of :meth:`Scheduler.run`
the clock's samples are rank 0's on every rank, so that
:meth:`Scheduler.stats` reads the same everywhere without a
collective.

:meth:`Scheduler.stats` keeps its own latency samples (TTFT and
per-token latency percentiles, tokens/s, decode steps, prefill calls).
Telemetry (``serve/*``, the JAX package's names): ``serve/ttft`` and
``serve/tok_latency`` histograms (milliseconds), ``serve/slot_occupancy``
and ``serve/pending_depth`` gauges, ``serve/tokens_generated`` /
``serve/requests_completed`` / ``serve/rejected`` / ``serve/expired`` /
``serve/quarantined`` / ``serve/drained`` counters, a ``serve`` event per
terminal request, ``health`` snapshots and a ``kv_cache`` census at the
end of a run. With the registry enabled each request gets a
``trace_id`` at submit (it survives ``dataclasses.replace``, so a
migrated continuation keeps it) and its spans: ``serve/queued``,
``serve/prefill``, ``serve/decode``, ``serve/evict`` under a root
``serve/request``, plus one ``serve/decode_chunk`` a dispatch. A
``guard=`` (:class:`~apex_tpu_torch.resilience.PreemptionGuard`) starts
the drain when its signal arrives.
"""

import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np

from apex_tpu_torch.parallel import groups
from apex_tpu_torch.serving import robust as robust_mod
from apex_tpu_torch.telemetry.registry import get_registry
from apex_tpu_torch.telemetry.trace import emit_span, new_span_id, \
    new_trace_id
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS


@dataclasses.dataclass
class Request:
    """One serving request. ``arrival`` is in decode ticks (virtual
    time; see the module docstring); ``max_new_tokens`` bounds
    generation (eos, when the engine's config defines one, may end it
    earlier). ``ttft_deadline_s`` / ``total_deadline_s`` override the
    scheduler's :class:`~apex_tpu_torch.serving.robust.RobustConfig`
    defaults for this request (None = inherit). ``tier`` is the SLO
    class a fleet router reads (the scheduler itself is tier-blind).
    ``trace_id`` is the request's causal identity (None = allocate at
    submit when telemetry is on); it survives ``dataclasses.replace``,
    so a migration continuation keeps the donor's id."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0
    ttft_deadline_s: Optional[float] = None
    total_deadline_s: Optional[float] = None
    tier: Optional[str] = None
    trace_id: Optional[str] = None


@dataclasses.dataclass
class CompletedRequest:
    rid: int
    tokens: np.ndarray          # generated tokens (prompt excluded)
    ttft_s: float               # eligible -> first token; NaN if never served
    mean_tok_latency_s: float   # decode steps only (excludes TTFT)
    finish_reason: str          # robust.OK_STATUSES | robust.FAILURE_STATUSES


def synthetic_trace(n_requests=16, *, seed=0, mean_interarrival=0.5,
                    prompt_lens=(4, 8, 12, 24), max_new=(8, 16, 24),
                    vocab_size=256, shared_prefix_len=0,
                    shared_frac=0.8):
    """Deterministic many-user trace: Poisson arrivals (exponential
    inter-arrival gaps in decode ticks) with mixed prompt/output
    lengths (the JAX package's ``bench.py serve_decode`` workload). Same
    seed, same trace, byte for byte, as the JAX package's.

    ``shared_prefix_len > 0`` makes the trace prefix-heavy (the
    realistic millions-of-users shape): one ``shared_prefix_len``-token
    system prompt is drawn once, and each request opens with it with
    probability ``shared_frac`` (its ``prompt_lens`` draw then sizes
    the UNIQUE tail). The default (0) leaves the legacy byte stream
    untouched — no extra RNG draws happen."""
    rs = np.random.RandomState(seed)
    gaps = rs.exponential(mean_interarrival, size=n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]        # first request at t=0
    shared = (rs.randint(0, vocab_size,
                         size=int(shared_prefix_len)).astype(np.int32)
              if shared_prefix_len else None)
    out = []
    for i in range(n_requests):
        plen = int(rs.choice(prompt_lens))
        prompt = rs.randint(0, vocab_size, size=plen).astype(np.int32)
        if shared is not None and rs.random_sample() < shared_frac:
            prompt = np.concatenate([shared, prompt])
        out.append(Request(
            rid=i,
            prompt=prompt,
            max_new_tokens=int(rs.choice(max_new)),
            arrival=float(arrivals[i])))
    return out


class _Active:
    __slots__ = ("req", "tokens", "last", "latencies", "ttft_s")

    def __init__(self, req, first_token, ttft_s):
        self.req = req
        self.tokens = [int(first_token)]
        self.last = int(first_token)
        self.latencies = []
        self.ttft_s = float(ttft_s)


class Scheduler:
    """Continuous batching over one
    :class:`~apex_tpu_torch.serving.engine.ServeEngine`.

    One :meth:`step` = expire deadline-blown requests, admit every
    eligible request into free slots (grouped prefills; skipped while
    draining), then one decode pass over the active set (padded to the
    engine's batch bucket with distinct free slots), then evict
    finished or poisoned sequences. :meth:`run` drives a request list to
    completion and fast-forwards virtual time across idle gaps.
    """

    def __init__(self, engine, *, registry=None, clock=time.perf_counter,
                 robust=None, guard=None):
        self.engine = engine
        self._registry = registry
        # process-row key on every span this scheduler emits (the JAX
        # package's fleet names a replica's here)
        self.trace_label = "serve"
        # rid -> {"trace_id", "root" (root span id), "submit_perf",
        # "eligible_perf", "admit_perf"} — populated only while the
        # registry is enabled; span timestamps use time.perf_counter()
        # directly (not self._clock, which tests may virtualize) so they
        # live on the registry's epoch clock
        self._tr = {}
        self.guard = guard
        self._tp = int(getattr(engine, "tp", 1))
        self._clock = clock
        self.robust = robust or robust_mod.RobustConfig()
        self.num_slots = engine.config.num_slots
        self.free = list(range(self.num_slots))
        self.pending: List[Request] = []
        self.active = {}                      # slot -> _Active
        self.completed: List[CompletedRequest] = []
        self.rejected: List[robust_mod.RejectedRequest] = []
        self.health = robust_mod.ServeHealth()
        self.tick = 0.0
        self.decode_steps = 0
        self.prefill_calls = 0
        self.tokens_generated = 0
        self.draining = False
        self.drain_report: Optional[robust_mod.DrainReport] = None
        self._drain_reason = None
        self._drain_start_wall = None
        self._drain_start_tick = None
        self._drain_completed_before = 0
        self._known_rids = set()
        self._eligible_wall = {}
        self._ttft_ms = []
        self._ttft_hit_ms = []                # prefix-cache hits
        self._ttft_miss_ms = []
        self._tok_latency_ms = []
        # speculative-decode acceptance accounting
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._t_start = None
        self._t_end = None
        self._retries_before = engine.decode_retries_total

    def _reg(self):
        return self._registry or get_registry()

    # -- submission & admission control ------------------------------------

    def _reject(self, request, reason, detail=""):
        """Record one shed or bounced request: host list + counter +
        JSONL event. Returns False (the ``submit`` contract)."""
        self.rejected.append(robust_mod.RejectedRequest(
            rid=request.rid, reason=reason, tick=self.tick,
            prompt_len=len(request.prompt), detail=detail))
        self.health.rejected += 1
        reg = self._reg()
        reg.counter("serve/rejected").inc()
        reg.event("serve", "rejected", rid=request.rid, reason=reason,
                  tick=self.tick, prompt_len=len(request.prompt),
                  detail=detail)
        return False

    def submit(self, request: Request):
        """Queue a request, or shed it. Returns True when queued; False
        when rejected, with the reason recorded in :attr:`rejected`
        (never an exception: admission control is traffic policy, not a
        caller bug)."""
        rc = self.robust
        eng = self.engine
        plen = len(request.prompt)
        self.health.submitted += 1
        if request.rid in self._known_rids:
            return self._reject(
                request, "duplicate_rid",
                f"rid {request.rid} is already tracked by this scheduler")
        if self.draining:
            return self._reject(
                request, "draining",
                "scheduler is draining; admissions are closed")
        if plen > eng.config.prefill_buckets[-1]:
            return self._reject(
                request, "prompt_too_long",
                f"prompt ({plen}) exceeds the largest prefill bucket "
                f"({eng.config.prefill_buckets[-1]})")
        headroom = eng.decode_headroom
        if plen + request.max_new_tokens + headroom > eng.max_len:
            return self._reject(
                request, "budget_too_long",
                f"prompt ({plen}) + max_new_tokens "
                f"({request.max_new_tokens})"
                + (f" + speculative window ({headroom})" if headroom
                   else "")
                + f" exceeds max_position_embeddings ({eng.max_len})")
        if rc.max_pending is not None and len(self.pending) >= rc.max_pending:
            if rc.admission_policy == "reject_newest":
                return self._reject(
                    request, "queue_full",
                    f"pending queue at max_pending ({rc.max_pending})")
            # shed_oldest: the newcomer is the one a user is still
            # waiting at; the oldest queued request has already blown
            # the most patience
            oldest = self.pending.pop(0)
            self._known_rids.discard(oldest.rid)
            self._tr.pop(oldest.rid, None)
            self._reject(oldest, "shed",
                         f"shed for rid {request.rid} "
                         f"(max_pending {rc.max_pending})")
        self._known_rids.add(request.rid)
        reg = self._reg()
        if reg.enabled:
            if request.trace_id is None:
                request.trace_id = new_trace_id()
            self._tr[request.rid] = {
                "trace_id": request.trace_id,
                "root": new_span_id(),
                "submit_perf": time.perf_counter(),
            }
        self.pending.append(request)
        self.pending.sort(key=lambda r: (r.arrival, r.rid))
        return True

    # -- terminal bookkeeping ----------------------------------------------

    _TERMINAL_COUNTERS = {
        "deadline_exceeded": "serve/expired",
        "poisoned": "serve/quarantined",
        "failed": "serve/failed",
        "drained": "serve/drained",
        "max_steps": "serve/cancelled",
    }

    def _terminal(self, req, reason, *, tokens=(), ttft_s=float("nan"),
                  latencies=(), **event_fields):
        """Land one request in a terminal state: completed-list record,
        per-status counter, ``serve`` JSONL event (every failure path
        funnels through here, so no request vanishes silently). When the
        request is traced its phase spans close here too:
        ``serve/decode`` (admission -> terminal), an instant
        ``serve/evict``, and the root ``serve/request``."""
        rec = CompletedRequest(
            rid=req.rid,
            tokens=np.asarray(list(tokens), np.int32),
            ttft_s=float(ttft_s),
            mean_tok_latency_s=(float(np.mean(list(latencies)))
                                if latencies else 0.0),
            finish_reason=reason)
        self.completed.append(rec)
        reg = self._reg()
        counter = self._TERMINAL_COUNTERS.get(reason)
        if counter:
            reg.counter(counter).inc()
        reg.counter("serve/requests_completed").inc()
        reg.counter("serve/tokens_generated").inc(len(rec.tokens))
        tr = self._tr.pop(req.rid, None)
        trace_fields = {}
        if tr is not None:
            trace_fields["trace_id"] = tr["trace_id"]
            self._close_request_trace(tr, req, reason, reg,
                                      tokens=len(rec.tokens))
        reg.event("serve", "request_done", rid=req.rid,
                  tokens=len(rec.tokens), prompt_len=len(req.prompt),
                  ttft_ms=(round(rec.ttft_s * 1e3, 3)
                           if np.isfinite(rec.ttft_s) else None),
                  mean_tok_latency_ms=round(
                      rec.mean_tok_latency_s * 1e3, 3),
                  finish_reason=reason, **trace_fields, **event_fields)
        return rec

    def _close_request_trace(self, tr, req, reason, reg, *, tokens):
        """Emit the end-of-life spans for one traced request (see
        :meth:`_terminal`). A request that never reached admission has
        no ``serve/decode`` span: its whole life was the queue."""
        now_p = time.perf_counter()
        admit = tr.get("admit_perf")
        if admit is not None:
            emit_span("serve/decode", admit, now_p, registry=reg,
                      trace_id=tr["trace_id"], parent_id=tr["root"],
                      rid=req.rid, replica=self.trace_label,
                      tokens=tokens)
        emit_span("serve/evict", now_p, now_p, registry=reg,
                  trace_id=tr["trace_id"], parent_id=tr["root"],
                  rid=req.rid, reason=reason, replica=self.trace_label)
        start = tr.get("eligible_perf", tr["submit_perf"])
        emit_span("serve/request", start, now_p, registry=reg,
                  trace_id=tr["trace_id"], span_id=tr["root"],
                  rid=req.rid, tier=req.tier, finish_reason=reason,
                  replica=self.trace_label, tokens=tokens)

    # -- the phases --------------------------------------------------------

    def _ttft_deadline(self, req):
        return (req.ttft_deadline_s if req.ttft_deadline_s is not None
                else self.robust.ttft_deadline_s)

    def _total_deadline(self, req):
        return (req.total_deadline_s if req.total_deadline_s is not None
                else self.robust.total_deadline_s)

    def _agree(self, value):
        """``value`` as tp rank 0 decided it, on every rank of a
        tensor-parallel engine's group; ``value`` itself at tp = 1."""
        if self._tp == 1:
            return value
        return groups.broadcast_object(value, TENSOR_PARALLEL_AXIS)

    def _decide(self):
        """What the clock decides before a step, read as :meth:`run` and
        :meth:`step` always read it: whether a draining run stops now (no
        work left, or the drain deadline passed), the pending requests
        past their TTFT deadline and the active slots past their
        total-latency deadline. Returns (stop, late rids, late slots,
        the reading). At tp > 1 tp rank 0's decisions hold on every
        rank, over one broadcast a step, and a drain on rank 0 starts
        every rank's. A ``guard`` whose signal arrived starts the drain
        (``"preempted"``)."""
        if not self.draining and self.guard is not None \
                and self.guard.preempted:
            self.drain("preempted")
        stop = self.draining and (not self.active
                                  or self._drain_deadline_passed())
        if self._t_start is None:
            self._t_start = self._clock()
        now = self._clock()

        def late(req, limit):
            t0 = self._eligible_wall.get(req.rid)
            return limit is not None and t0 is not None and now - t0 > limit

        late_rids = [r.rid for r in self.pending
                     if late(r, self._ttft_deadline(r))]
        late_slots = [slot for slot in sorted(self.active)
                      if late(self.active[slot].req,
                              self._total_deadline(self.active[slot].req))]
        drain, stop, late_rids, late_slots = self._agree(
            (self._drain_reason if self.draining else None, stop,
             late_rids, late_slots))
        if drain is not None:
            self.drain(drain)
        return stop, late_rids, late_slots, now

    def _expire_deadlines(self, late_rids, late_slots, now):
        """Evict the requests :meth:`_decide` found past their budget
        (queued ones past their TTFT deadline, active ones past their
        total-latency deadline) with the ``deadline_exceeded`` terminal
        status."""
        # eligibility is stamped here (not only at admission) so a
        # request stuck in the queue accrues wait time toward its TTFT
        # deadline from the moment it became eligible
        now_p = time.perf_counter() if self._tr else None
        for r in self.pending:
            if r.arrival <= self.tick:
                self._eligible_wall.setdefault(r.rid, now)
                if now_p is not None and r.rid in self._tr:
                    self._tr[r.rid].setdefault("eligible_perf", now_p)
        for r in [r for r in self.pending if r.rid in set(late_rids)]:
            self.pending.remove(r)
            self.health.expired += 1
            self._terminal(r, "deadline_exceeded", where="pending",
                           waited_ms=round(
                               (now - self._eligible_wall[r.rid]) * 1e3, 3))
        for slot in late_slots:
            st = self.active[slot]
            del self.active[slot]
            self._release(slot)
            self.health.expired += 1
            self._terminal(st.req, "deadline_exceeded", where="active",
                           tokens=st.tokens, ttft_s=st.ttft_s,
                           latencies=st.latencies, waited_ms=round(
                               (now - self._eligible_wall[st.req.rid])
                               * 1e3, 3))

    def _admit(self):
        now = self._clock()
        now_p = time.perf_counter() if self._tr else None
        eligible = [r for r in self.pending if r.arrival <= self.tick]
        for r in eligible:
            self._eligible_wall.setdefault(r.rid, now)
            if now_p is not None and r.rid in self._tr:
                self._tr[r.rid].setdefault("eligible_perf", now_p)
        buckets = self.engine.config.batch_buckets
        while eligible and self.free:
            # the prefill call occupies a whole batch bucket (real + pad
            # slots, all distinct), so the group shrinks to the largest
            # bucket that fits entirely inside the free pool
            fits = [b for b in buckets if b <= len(self.free)]
            if not fits:
                break
            group = eligible[:min(len(self.free), fits[-1])]
            eligible = eligible[len(group):]
            for r in group:
                self.pending.remove(r)
            slots = [self.free.pop(0) for _ in group]
            p0 = time.perf_counter() if self._tr else None
            first = self.engine.prefill(
                slots, [r.prompt for r in group], pad_slot_ids=self.free)
            t1 = self._clock()
            p1 = time.perf_counter() if self._tr else None
            self.prefill_calls += 1
            cuts = list(self.engine.last_prefill_hits or [0] * len(group))
            reg = self._reg()
            for slot, r, tok, cut in zip(slots, group, first, cuts):
                ttft = t1 - self._eligible_wall[r.rid]
                self._ttft_ms.append(ttft * 1e3)
                (self._ttft_hit_ms if cut
                 else self._ttft_miss_ms).append(ttft * 1e3)
                reg.histogram("serve/ttft").observe(ttft * 1e3)
                if cut:
                    reg.histogram("serve/ttft_prefix_hit").observe(
                        ttft * 1e3)
                reg.counter("serve/requests_admitted").inc()
                tr = self._tr.get(r.rid)
                if tr is not None:
                    emit_span("serve/queued",
                              tr.get("eligible_perf", tr["submit_perf"]),
                              p0, registry=reg, trace_id=tr["trace_id"],
                              parent_id=tr["root"], rid=r.rid,
                              replica=self.trace_label)
                    emit_span("serve/prefill", p0, p1, registry=reg,
                              trace_id=tr["trace_id"],
                              parent_id=tr["root"], rid=r.rid,
                              slot=slot, prefix_cut=int(cut),
                              replica=self.trace_label)
                    tr["admit_perf"] = p1
                self.tokens_generated += 1
                st = _Active(r, tok, ttft)
                if self._finished(st):
                    self._evict(slot, st)
                else:
                    self.active[slot] = st

    def _finished(self, st):
        eos = self.engine.config.eos_token_id
        if eos is not None and st.last == eos:
            return True
        return len(st.tokens) >= st.req.max_new_tokens

    def _decode_once(self):
        if not self.active:
            return
        rc = self.robust
        spec = self.engine.spec_enabled
        trace_on = self._reg().enabled
        max_bucket = self.engine.config.batch_buckets[-1]
        slots = sorted(self.active)
        for i in range(0, len(slots), max_bucket):
            chunk = slots[i:i + max_bucket]
            toks = [self.active[s].last for s in chunk]
            t0 = self._clock()
            p0 = time.perf_counter() if trace_on else None
            try:
                out = self.engine.decode(
                    chunk, toks, pad_slot_ids=self.free,
                    retries=rc.decode_retries,
                    backoff_s=rc.retry_backoff_s,
                    backoff_cap_s=rc.retry_backoff_cap_s)
                if spec:
                    emitted, counts, finite = out
                else:
                    nxt, finite = out
            except robust_mod.DecodeFailedError as e:
                # persistent failure: fail only this chunk's requests;
                # other chunks (and future traffic) continue
                self.health.decode_failures += 1
                reg = self._reg()
                reg.counter("serve/decode_failures").inc()
                reg.event("serve", "decode_failed", slots=list(chunk),
                          attempts=e.attempts,
                          error=type(e.last_error).__name__)
                for s in chunk:
                    st = self.active.pop(s)
                    self._release(s)
                    self.health.failed += 1
                    self._terminal(st.req, "failed", tokens=st.tokens,
                                   ttft_s=st.ttft_s, latencies=st.latencies,
                                   attempts=e.attempts)
                continue
            dt = self._clock() - t0
            self.decode_steps += 1
            reg = self._reg()
            reg.counter("serve/decode_steps").inc()
            if p0 is not None and reg.enabled:
                # engine-row span: one per dispatch, covering the chunk
                emit_span("serve/decode_chunk", p0, registry=reg,
                          slots=len(chunk), spec=spec,
                          replica=self.trace_label, tick=self.tick)
            if rc.quarantine and len(chunk) >= 2 and not finite.any():
                # every slot non-finite at once: poisoned weights or
                # activations, not one poisoned request (a 1-slot batch
                # cannot tell the two apart, so it stays a quarantine)
                self.health.all_slots_nonfinite += 1
                for s in chunk:
                    st = self.active.pop(s)
                    self._quarantine(s, st)
                reg.event("serve", "all_slots_nonfinite",
                          slots=list(chunk), tick=self.tick)
                raise robust_mod.NonFiniteError(
                    f"every slot in the decode batch ({list(chunk)}) "
                    f"produced non-finite logits at tick {self.tick}: this "
                    f"is model-level poison (weights/activations), not a "
                    f"per-request fault")
            if spec:
                # proposed = k per real slot; accepted = counts - 1 (the
                # +1 is the target's own correction or bonus token)
                k = int(self.engine.config.num_draft_tokens)
                proposed = k * len(chunk)
                accepted = int(sum(int(c) - 1
                                   for c, ok in zip(counts, finite) if ok))
                self.spec_proposed += proposed
                self.spec_accepted += accepted
                reg.counter("serve/spec_proposed").inc(proposed)
                if accepted:
                    reg.counter("serve/spec_accepted").inc(accepted)
                blocks = [list(emitted[j][:int(counts[j])])
                          for j in range(len(chunk))]
            else:
                blocks = [[tok] for tok in nxt]
            for s, block, ok in zip(chunk, blocks, finite):
                st = self.active[s]
                if rc.quarantine and not ok:
                    del self.active[s]
                    self._quarantine(s, st)
                    continue
                # one call may emit several verified tokens; the
                # per-token latency is the call amortized over them, and
                # eos / max_new truncate the block exactly where a
                # one-token engine would have stopped
                per_tok = dt / max(len(block), 1)
                done = False
                for tok in block:
                    st.tokens.append(int(tok))
                    st.last = int(tok)
                    st.latencies.append(per_tok)
                    self._tok_latency_ms.append(per_tok * 1e3)
                    reg.histogram("serve/tok_latency").observe(per_tok * 1e3)
                    self.tokens_generated += 1
                    if self._finished(st):
                        done = True
                        break
                if done:
                    del self.active[s]
                    self._evict(s, st)

    def _release(self, slot):
        self.free.append(slot)
        self.free.sort()

    def _quarantine(self, slot, st):
        """Evict one poisoned sequence: its KV rows were already zeroed
        by the decode step; the slot returns to the free pool and the
        request lands with status ``poisoned``."""
        self._release(slot)
        self.health.quarantined += 1
        self._terminal(st.req, "poisoned", tokens=st.tokens,
                       ttft_s=st.ttft_s, latencies=st.latencies,
                       slot=slot, tick=self.tick)

    def _evict(self, slot, st):
        if slot in self.active:
            del self.active[slot]
        self._release(slot)
        eos = self.engine.config.eos_token_id
        reason = "eos" if (eos is not None and st.last == eos) else "length"
        self._terminal(st.req, reason, tokens=st.tokens, ttft_s=st.ttft_s,
                       latencies=st.latencies)

    # -- migration ---------------------------------------------------------

    def extract_unfinished(self, reason="migrated", which="all"):
        """Take in-flight and/or queued requests out of this scheduler
        without a terminal status, for migration to another engine.
        Returns one record per request, ``{"request", "tokens" (emitted
        so far), "ttft_s", "latencies", "where", "slot"}``: the
        continuation is the prompt plus the emitted tokens (greedy decode
        resumes it token for token). ``"slot"`` is the store slot the
        request held (None for a pending one): releasing it only returns
        the id to the free pool, so ``engine.extract_kv_state`` can still
        read its rows after this sweep, as long as nothing prefills in
        between. ``which`` is ``"all"``, ``"active"`` or ``"pending"``.
        Each extraction ticks ``serve/extracted`` and lands a
        ``serve``/``extracted`` event naming ``reason``; a traced
        request's spans close here (the survivor opens a new root under
        the same ``trace_id``)."""
        if which not in ("all", "active", "pending"):
            raise ValueError(f"which ({which!r}) not in "
                             f"('all', 'active', 'pending')")
        out = []
        if which in ("all", "active"):
            for slot in sorted(self.active):
                st = self.active.pop(slot)
                self._release(slot)
                out.append({"request": st.req, "tokens": list(st.tokens),
                            "ttft_s": st.ttft_s,
                            "latencies": list(st.latencies),
                            "where": "active", "slot": slot})
        if which in ("all", "pending"):
            for r in list(self.pending):
                self.pending.remove(r)
                out.append({"request": r, "tokens": [],
                            "ttft_s": float("nan"), "latencies": [],
                            "where": "pending", "slot": None})
        reg = self._reg()
        for rec in out:
            rid = rec["request"].rid
            self._known_rids.discard(rid)
            self._eligible_wall.pop(rid, None)
            reg.counter("serve/extracted").inc()
            tr = self._tr.pop(rid, None)
            trace_fields = {}
            if tr is not None:
                trace_fields["trace_id"] = tr["trace_id"]
                self._close_request_trace(tr, rec["request"], reason, reg,
                                          tokens=len(rec["tokens"]))
            reg.event("serve", "extracted", rid=rid, reason=reason,
                      where=rec["where"], tokens=len(rec["tokens"]),
                      tick=self.tick, **trace_fields)
        return out

    # -- drain -------------------------------------------------------------

    def drain(self, reason="requested"):
        """Stop admissions now; :meth:`run` finishes in-flight work up to
        ``robust.drain_deadline_s`` and records the drain report. At tp >
        1 a drain on tp rank 0 drains every rank from its next step."""
        if not self.draining:
            self.draining = True
            self._drain_reason = reason
            self._drain_start_wall = self._clock()
            self._drain_start_tick = self.tick
            self._drain_completed_before = len(self.completed)
            self._reg().event("serve", "drain_start", reason=reason,
                              tick=self.tick, active=len(self.active),
                              pending=len(self.pending))

    def _drain_deadline_passed(self):
        return (self._clock() - self._drain_start_wall
                > self.robust.drain_deadline_s)

    def _finish_drain(self):
        """Cancel whatever the drain deadline stranded (status
        ``drained``) and record the report."""
        cancelled_active = 0
        for slot in sorted(self.active):
            st = self.active.pop(slot)
            self._release(slot)
            self.health.drained += 1
            cancelled_active += 1
            self._terminal(st.req, "drained", tokens=st.tokens,
                           ttft_s=st.ttft_s, latencies=st.latencies)
        cancelled_pending = 0
        for r in list(self.pending):
            self.pending.remove(r)
            self.health.drained += 1
            cancelled_pending += 1
            self._terminal(r, "drained", where="pending")
        self.drain_report = robust_mod.DrainReport(
            reason=self._drain_reason,
            started_tick=self._drain_start_tick,
            drain_s=self._clock() - self._drain_start_wall,
            completed_in_drain=(len(self.completed)
                                - self._drain_completed_before
                                - cancelled_active - cancelled_pending),
            cancelled_active=cancelled_active,
            cancelled_pending=cancelled_pending,
            deadline_hit=cancelled_active > 0)
        self._reg().event("serve", "drain_report",
                          **self.drain_report.as_event_fields())

    # -- driving -----------------------------------------------------------

    def step(self):
        """One scheduler iteration: expire deadline-blown requests, admit
        (unless draining), decode once, advance the virtual clock one
        tick."""
        self._step(*self._decide()[1:])

    def _step(self, late_rids, late_slots, now):
        """:meth:`step` on :meth:`_decide`'s decisions."""
        self._expire_deadlines(late_rids, late_slots, now)
        if not self.draining:
            self._admit()
        self._decode_once()
        self.tick += 1.0
        self._reg().gauge("serve/slot_occupancy").set(
            len(self.active) / self.num_slots)
        every = self.robust.health_every
        if every and int(self.tick) % every == 0:
            self._health_event()

    def run(self, requests=None, *, max_steps=100_000):
        """Drive ``requests`` (plus anything already submitted) to a
        terminal state; returns the completed list in finish order.
        Every request ends with an explicit ``finish_reason``."""
        for r in requests or ():
            self.submit(r)
        steps = 0
        while self.pending or self.active:
            stop, *decided = self._decide()
            if stop:
                break
            if not self.active and self.pending and \
                    min(r.arrival for r in self.pending) > self.tick:
                # idle gap: fast-forward virtual time to the next arrival
                # (no request turns late by it: lateness needs a stamp,
                # and stamps are taken in the step)
                self.tick = min(r.arrival for r in self.pending)
            self._step(*decided)
            steps += 1
            if steps > max_steps:
                self._exhaust_max_steps(max_steps)
                break
        if self.draining:
            self._finish_drain()
        self._t_end = self._clock()
        # at tp > 1 the clock's samples of tp rank 0, so that stats()
        # reads the same on every rank
        (self._t_start, self._t_end, self._ttft_ms, self._ttft_hit_ms,
         self._ttft_miss_ms, self._tok_latency_ms,
         self.drain_report) = self._agree((
             self._t_start, self._t_end, self._ttft_ms, self._ttft_hit_ms,
             self._ttft_miss_ms, self._tok_latency_ms, self.drain_report))
        self._census_event()
        self._spec_prefix_events()
        self._health_event()
        return self.completed

    def _exhaust_max_steps(self, max_steps):
        """``max_steps`` ran out with work left: cancel it loudly
        (terminal status ``max_steps`` per request plus a warning)."""
        stranded_active = len(self.active)
        stranded_pending = len(self.pending)
        for slot in sorted(self.active):
            st = self.active.pop(slot)
            self._release(slot)
            self.health.max_steps += 1
            self._terminal(st.req, "max_steps", tokens=st.tokens,
                           ttft_s=st.ttft_s, latencies=st.latencies)
        for r in list(self.pending):
            self.pending.remove(r)
            self.health.max_steps += 1
            self._terminal(r, "max_steps", where="pending")
        self._reg().event("serve", "max_steps_exhausted",
                          max_steps=max_steps, tick=self.tick,
                          cancelled_active=stranded_active,
                          cancelled_pending=stranded_pending)
        warnings.warn(
            f"scheduler exhausted max_steps ({max_steps}) with "
            f"{stranded_pending} pending / {stranded_active} active "
            f"request(s): all cancelled with terminal status 'max_steps' "
            f"(a request was not converging)", stacklevel=3)

    def _census_event(self):
        eng = self.engine
        reg = self._reg()
        reg.gauge("serve/kv_cache_bytes").set(eng.kv_cache_bytes())
        reg.event("serve", "kv_cache",
                  slots_total=self.num_slots,
                  slots_used=len(self.active),
                  slots_free=len(self.free),
                  bytes_per_slot=eng.spec.bytes_per_slot(),
                  cache_dtype=eng.spec.cache_dtype_name(),
                  kv_cache_bytes=eng.kv_cache_bytes())

    def _spec_prefix_events(self):
        """End-of-run rollups for the two serving multipliers (only when
        the engine runs them): speculative acceptance, prefix-store
        hits."""
        reg = self._reg()
        if self.engine.spec_enabled:
            rate = (self.spec_accepted / self.spec_proposed
                    if self.spec_proposed else 0.0)
            reg.gauge("serve/spec_acceptance_rate").set(rate)
            reg.event("serve", "spec_report",
                      proposed=self.spec_proposed,
                      accepted=self.spec_accepted,
                      acceptance_rate=round(rate, 4),
                      num_draft_tokens=int(
                          self.engine.config.num_draft_tokens),
                      decode_steps=self.decode_steps,
                      tokens_generated=self.tokens_generated)
        store = getattr(self.engine, "prefix_store", None)
        if store is not None:
            s = store.stats()
            reg.gauge("serve/prefix_hit_rate").set(s["hit_rate"])
            reg.event("serve", "prefix_report", **s)

    def _health_event(self):
        self.health.decode_retries = (self.engine.decode_retries_total
                                      - self._retries_before)
        self.health.emit(
            self._reg(), tick=self.tick, pending=len(self.pending),
            active=len(self.active), free=len(self.free),
            completed_ok=sum(
                1 for c in self.completed
                if c.finish_reason in robust_mod.OK_STATUSES),
            draining=self.draining)

    # -- accounting --------------------------------------------------------

    @staticmethod
    def _pct(samples, q):
        return float(np.percentile(samples, q)) if samples else None

    def stats(self):
        """Summary of the run, from the scheduler's own samples (after
        :meth:`run` at tp > 1, tp rank 0's clock's on every rank).
        Goodput counts only requests that finished ``length``/``eos``;
        every failure mode has its own count next to the shed rate."""
        # a reading of 0.0 is a time like any other (a virtual clock's)
        end = self._clock() if self._t_end is None else self._t_end
        wall = end - (end if self._t_start is None else self._t_start)
        self.health.decode_retries = (self.engine.decode_retries_total
                                      - self._retries_before)
        by_reason = {}
        goodput_tokens = 0
        for c in self.completed:
            by_reason[c.finish_reason] = by_reason.get(c.finish_reason,
                                                       0) + 1
            if c.finish_reason in robust_mod.OK_STATUSES:
                goodput_tokens += len(c.tokens)
        h = self.health
        extra = {}
        if self.engine.spec_enabled:
            extra.update({
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "acceptance_rate": round(
                    self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else 0.0,
                # every emitted token is target-verified, so the
                # accepted-tokens rate is the engine's tokens/s
                "accepted_tokens_per_sec": (self.tokens_generated / wall)
                if wall > 0 else None,
            })
        store = getattr(self.engine, "prefix_store", None)
        if store is not None:
            ps = store.stats()
            extra.update({
                "prefix_lookups": ps["lookups"],
                "prefix_hits": ps["hits"],
                "prefix_hit_rate": round(ps["hit_rate"], 4),
                "prefix_hit_tokens": ps["hit_tokens"],
                "prefix_store_bytes": ps["bytes"],
                "prefix_store_entries": ps["entries"],
                "ttft_p50_prefix_hit_ms": self._pct(self._ttft_hit_ms, 50),
                "ttft_p50_prefix_miss_ms": self._pct(self._ttft_miss_ms, 50),
            })
        return {
            **extra,
            "requests_completed": len(self.completed),
            "requests_ok": sum(by_reason.get(r, 0)
                               for r in robust_mod.OK_STATUSES),
            "requests_by_reason": by_reason,
            "requests_rejected": h.rejected,
            "requests_expired": h.expired,
            "requests_quarantined": h.quarantined,
            "requests_failed": h.failed,
            "requests_drained": h.drained,
            "shed_rate": round(h.shed_rate(), 4),
            "decode_retries": h.decode_retries,
            "tokens_generated": self.tokens_generated,
            "goodput_tokens": goodput_tokens,
            "wall_s": wall,
            "tokens_per_sec": (self.tokens_generated / wall)
            if wall > 0 else None,
            "goodput_tokens_per_sec": (goodput_tokens / wall)
            if wall > 0 else None,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "ttft_p50_ms": self._pct(self._ttft_ms, 50),
            "ttft_p99_ms": self._pct(self._ttft_ms, 99),
            "tok_latency_p50_ms": self._pct(self._tok_latency_ms, 50),
            "tok_latency_p99_ms": self._pct(self._tok_latency_ms, 99),
            "slot_occupancy_last": len(self.active) / self.num_slots,
        }
