"""Cross-request prefix cache: shared system prompts prefill once.

Counterpart of ``apex_tpu/serving/prefix_cache.py``. Most prompts of a
many-user trace open with one of a few system prompts, so the engine
keeps a host-side store of prompts it prefilled before, keyed by a hash
of their first ``min_len`` tokens. On admission it looks up the longest
cached prefix of a new prompt; on a hit the slot's KV rows are seeded
from the cached entry and the prefill runs only the suffix bucket, at
positions ``cut + arange(S)``.

- One entry serves every shorter cut of its tokens: reusing a shorter
  prefix is just a smaller fill level at seed time (positions past the
  cut stay resident but masked, as a speculative rollback leaves them).
- Entries hold the raw rows (model layout, full precision) as host
  tensors, never the quantized store form: a hit's suffix forward must
  attend over exactly the prefix K/V a cold prefill computed, and
  requantizing the raw prefix then reproduces the cold store's int8
  blocks. Seeding dequantized int8 rows would perturb every suffix K/V
  through the lossy prefix, enough to flip a near-tie argmax many tokens
  later.

Everything here is host bookkeeping: nothing touches the device.
Per-caller attribution goes through ``scope=`` on :meth:`PrefixStore.
lookup` and :meth:`PrefixStore.insert` (per-scope counters beside the
global ones, ``stats()["by_scope"]``), so engines sharing one store
(:meth:`~apex_tpu_torch.serving.engine.ServeEngine.adopt_prefix_store`)
each report their own hits. Memory is bounded by ``max_entries`` entries
of one slot row each (plus the draft row when decoding speculatively),
evicted least recently used first.
"""

import hashlib

import numpy as np

from apex_tpu_torch.serving.kv_cache import tree_bytes


def _tok_bytes(tokens):
    return np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()


def _common_prefix_len(a, b):
    n = min(a.shape[0], b.shape[0])
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PrefixEntry:
    """One cached prompt: its tokens and host copies of the raw slot rows
    its prefill produced (and the draft model's row when the engine
    decodes speculatively)."""

    __slots__ = ("tokens", "rows", "draft_rows", "hits", "bytes")

    def __init__(self, tokens, rows, draft_rows=None):
        self.tokens = np.asarray(tokens, np.int32)
        self.rows = rows
        self.draft_rows = draft_rows
        self.hits = 0
        self.bytes = tree_bytes(rows) + (
            tree_bytes(draft_rows) if draft_rows is not None else 0)


class PrefixStore:
    """Bounded LRU store of prefilled prompts keyed by prefix hash.

    ``min_len`` is both the keying width (entries index under the hash of
    their first ``min_len`` tokens, so a lookup scans only candidates that
    share that much) and the floor below which a hit is not worth
    seeding. A lookup returns the longest common prefix with any
    candidate, capped at ``len(prompt) - 1``: the suffix prefill needs at
    least one real token to sample the first output from."""

    def __init__(self, *, max_entries=8, min_len=4):
        if max_entries < 1:
            raise ValueError(f"max_entries ({max_entries}) must be >= 1")
        if min_len < 1:
            raise ValueError(f"min_len ({min_len}) must be >= 1")
        self.max_entries = int(max_entries)
        self.min_len = int(min_len)
        self._order = []             # LRU order: index 0 = oldest
        self._index = {}             # prefix-hash key -> [entries]
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.insertions = 0
        self.evictions = 0
        self._scopes = {}            # scope name -> per-scope counters

    def _scope(self, name):
        return self._scopes.setdefault(str(name), {
            "lookups": 0, "hits": 0, "hit_tokens": 0, "insertions": 0})

    def _key(self, tokens):
        return hashlib.sha1(_tok_bytes(tokens[:self.min_len])).hexdigest()

    def __len__(self):
        return len(self._order)

    def total_bytes(self):
        return sum(e.bytes for e in self._order)

    def _touch(self, entry):
        self._order.remove(entry)
        self._order.append(entry)

    def _drop(self, entry):
        self._order.remove(entry)
        bucket = self._index[self._key(entry.tokens)]
        bucket.remove(entry)
        if not bucket:
            del self._index[self._key(entry.tokens)]

    def lookup(self, prompt, *, scope=None):
        """Longest usable cached prefix of ``prompt``: ``(cut, entry)``
        with ``cut`` the prefix tokens the entry covers, ``(0, None)`` on
        a miss. ``cut`` never exceeds ``len(prompt) - 1`` and never falls
        below ``min_len``. ``scope`` also counts the lookup (and any hit)
        for that caller."""
        prompt = np.asarray(prompt, np.int32)
        self.lookups += 1
        sc = self._scope(scope) if scope is not None else None
        if sc is not None:
            sc["lookups"] += 1
        if prompt.shape[0] <= self.min_len:
            return 0, None
        best_cut, best = 0, None
        for entry in self._index.get(self._key(prompt), ()):
            cut = min(_common_prefix_len(entry.tokens, prompt),
                      prompt.shape[0] - 1)
            if cut >= self.min_len and cut > best_cut:
                best_cut, best = cut, entry
        if best is None:
            return 0, None
        self._touch(best)
        best.hits += 1
        self.hits += 1
        self.hit_tokens += best_cut
        if sc is not None:
            sc["hits"] += 1
            sc["hit_tokens"] += best_cut
        return best_cut, best

    def covers(self, prompt):
        """True when some entry already holds all of ``prompt``:
        inserting it again would add bytes but no reusable prefix."""
        prompt = np.asarray(prompt, np.int32)
        return any(
            _common_prefix_len(e.tokens, prompt) >= prompt.shape[0]
            for e in self._index.get(self._key(prompt), ()))

    def insert(self, prompt, rows, draft_rows=None, *, scope=None):
        """Cache one prefilled prompt (host copies of its raw rows).
        Refuses prompts of ``min_len`` tokens or fewer (nothing to key on
        plus a suffix) and prompts already covered; an entry whose prompt
        is a strict prefix of the new one is replaced (the longer entry
        serves every shorter cut); evicts the least recently used past
        ``max_entries``. Returns the entry or None."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.shape[0] <= self.min_len or self.covers(prompt):
            return None
        key = self._key(prompt)
        for old in list(self._index.get(key, ())):
            if (_common_prefix_len(old.tokens, prompt)
                    >= old.tokens.shape[0]):
                self._drop(old)
        entry = PrefixEntry(prompt, rows, draft_rows)
        self._order.append(entry)
        self._index.setdefault(key, []).append(entry)
        self.insertions += 1
        if scope is not None:
            self._scope(scope)["insertions"] += 1
        while len(self._order) > self.max_entries:
            self._drop(self._order[0])
            self.evictions += 1
        return entry

    def stats(self):
        return {
            "entries": len(self._order),
            "bytes": self.total_bytes(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": (self.hits / self.lookups) if self.lookups
            else 0.0,
            "hit_tokens": self.hit_tokens,
            "insertions": self.insertions,
            "evictions": self.evictions,
            "by_scope": {
                name: dict(c) for name, c in sorted(self._scopes.items())
            },
        }

    def scope_stats(self, scope):
        """One scope's counters (zeros if it never called in)."""
        c = self._scopes.get(str(scope))
        return dict(c) if c else {
            "lookups": 0, "hits": 0, "hit_tokens": 0, "insertions": 0}
