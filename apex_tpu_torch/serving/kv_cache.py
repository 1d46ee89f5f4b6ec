"""Slotted KV-cache store for continuous-batching decode.

Counterpart of ``apex_tpu/serving/kv_cache.py``: one *slot* per
concurrent sequence, preallocated on the model's device for its full
``max_position_embeddings`` window, and each slot's fill level. The
engine gathers a bucket of slot rows, runs the model's own KV-cache
decode over them (each row at its own level, so mixed lengths share a
batch), and scatters the rows back; admission is a prefill scattered
into free slots, eviction just forgets a slot id.

Layout. Per layer, K and V of every slot: ``[max_len, num_slots, g, d]``
in ``compute_dtype`` (mode ``"bf16"``: the model's own cache layout,
so a bucket gathered along the slot axis is a model-ready cache), or in
mode ``"int8"`` the blockwise symmetric int8 codes ``{"q": int8
[max_len, num_slots, nb, B], "scale": fp32 [max_len, num_slots, nb,
1]}`` of each position's ``g * d`` lanes (the layout
:func:`apex_tpu_torch.kernels.fused_cc.spec_verify_attention` reads);
and the fill levels ``"lengths"``, int32 [num_slots]. The JAX store
puts the slot axis first; the bytes are the same.

int8 mode quantizes each cache position on its own
(:func:`~apex_tpu_torch.parallel.compression.quantize_rows_blockwise`
over the flattened ``g * d`` lanes, blocks of ``min(block_size, g * d)``
lanes), so appending a position never re-quantizes, and never drifts,
the positions written before it: :meth:`KVCacheSpec.update_rows_at` and
:meth:`KVCacheSpec.update_rows_span` requantize only the positions they
append and pass every other block's codes and scale through bit for
bit. Reads dequantize the gathered rows (:meth:`KVCacheSpec.
materialize_rows`), with a per-lane error of at most half a grid step,
``absmax_block / 254``.

Raw rows. The prefix cache and KV migration move one slot's rows in the
model's own layout at full precision, whatever the store's mode
(:meth:`KVCacheSpec.host_zero_row`): per layer K/V ``[max_len, 1, g, d]``
in the compute dtype and the fill level ``lengths`` int32 [1]. A
seeded prefill starts from a bucket of such rows, a seed buffer
``[2, L, max_len, b, g, d]`` (:meth:`KVCacheSpec.seed_buffer`, K then V,
each layer's ``[max_len, b, g, d]`` a contiguous view), and
:meth:`KVCacheSpec.consolidate_host_rows` turns one slot's store rows
back into raw rows (int8 blocks dequantized).

Tensor parallelism (a spec built under a tp grid of ``tp`` ranks, or
given ``tp``): each rank's store holds its own ``g / tp`` groups, in
int8 mode its own blocks of its ``g / tp * d`` lanes with its own
scales (JAX's ``store_pspecs``: the groups or blocks axis sharded over
the model axis), and the fill levels replicate. Raw rows stay in the
canonical, tp-independent layout (all ``g`` groups): a seed row is cut
to this rank's groups on its way to the card (:meth:`KVCacheSpec.
rank_slice`, JAX's ``row_pspecs`` in-specs), a new prompt's raw rows are
gathered over the ranks before they go to the prefix store, and
:meth:`KVCacheSpec.consolidate_host_rows` takes JAX's global view of a
slot's store rows (the ranks' shards concatenated on that axis in rank
order), so that engines of any tp seed from the same entries.
"""

import zlib

import numpy as np
import torch

from apex_tpu_torch.models.kv_cache import KVCache
from apex_tpu_torch.parallel import compression
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    gather_from_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide

CACHE_MODES = ("bf16", "int8")
KV_LEAVES = ("keys", "values")


def _leaves(tree):
    """Leaves of a nested dict/list tree in JAX's flatten order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _bytes(leaf):
    """A leaf's bytes as a contiguous buffer (not copied where the leaf
    already is one)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def payload_checksum(tree, crc=0):
    """crc32 over every leaf of a tree of tensors or arrays, in flatten
    order (dict keys sorted), as the JAX package's. Chainable: pass a
    previous checksum as ``crc`` to fold several trees into one."""
    for leaf in _leaves(tree):
        crc = zlib.crc32(_bytes(leaf), crc)
    return int(crc)


def tree_bytes(tree):
    """Bytes of every leaf of a tree of tensors or arrays."""
    return int(sum(leaf.numel() * leaf.element_size()
                   if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf).nbytes for leaf in _leaves(tree)))


def store_lengths(store):
    """Per-slot fill levels ``[num_slots]`` int32, on the store's
    device."""
    return store["lengths"]


def _map_kv(fn, rows):
    """``rows`` with ``fn`` applied to every K/V leaf (a tensor, or the
    int8 ``{"q", "scale"}`` pair); the fill levels pass through."""
    def leaf(x):
        if isinstance(x, dict):
            return {key: fn(x[key]) for key in ("q", "scale")}
        return fn(x)
    return {**{name: [leaf(x) for x in rows[name]] for name in KV_LEAVES},
            "lengths": rows["lengths"]}


def _gather_groups(x):
    """The tp ranks' ``x [..., n, w]`` (their groups, or their int8
    blocks and scales) concatenated on ``n`` in rank order: the ranks'
    ``n * w`` lanes gathered as the tp region's last dim."""
    return gather_from_tensor_model_parallel_region(
        x.flatten(-2)).unflatten(-1, (-1, x.shape[-1]))


class KVCacheSpec:
    """Layout of a slotted store for ``model`` (a port ``GPTModel``) and
    the conversions between the store and model-ready cache rows. The
    spec owns no device memory: :meth:`allocate` makes the store the
    engine owns. ``tp`` and ``rank`` (default the grid's tensor-parallel
    size and this process's rank in it) size this rank's share of the
    heads and place it."""

    def __init__(self, model, num_slots, *, mode="bf16",
                 block_size=compression.BLOCK_SIZE, tp=None, rank=None):
        if mode not in CACHE_MODES:
            raise ValueError(f"cache mode {mode!r} not in {CACHE_MODES}")
        if num_slots < 1:
            raise ValueError(f"num_slots ({num_slots}) must be >= 1")
        cfg = model.config
        self.model = model
        self.num_slots = int(num_slots)
        self.mode = mode
        self.block_size = int(block_size)
        self.num_layers = model.num_layers
        self.max_len = cfg.max_position_embeddings
        self.tp = int(tp or
                      parallel_state.get_tensor_model_parallel_world_size())
        self.rank = int(parallel_state.get_tensor_model_parallel_rank()
                        if rank is None else rank)
        # this rank's groups; raw rows hold all of them (the canonical
        # layout)
        self.groups = divide(cfg.query_groups, self.tp)
        self.canonical_groups = cfg.query_groups
        self.head_dim = cfg.kv_channels
        self.dtype = cfg.compute_dtype
        self.device = model.device
        # lanes per cache position: the blockwise quantization row
        self.width = self.groups * self.head_dim
        # the 256-lane grid clamped to the row: a K/V row narrower than a
        # block would otherwise store zero-padded lanes at full price
        self.block = min(self.block_size, self.width)
        self.blocks = compression.num_blocks(self.width, self.block)

    # -- layout ------------------------------------------------------------

    def allocate(self):
        """Zeroed store: per layer ``keys`` and ``values`` (bf16 mode
        ``[max_len, num_slots, g, d]``, int8 mode the ``{"q", "scale"}``
        pair) and ``lengths`` int32 [num_slots], on the model's
        device."""
        T, S = self.max_len, self.num_slots

        def leaf():
            if self.mode == "int8":
                return {"q": torch.zeros(T, S, self.blocks, self.block,
                                         dtype=torch.int8,
                                         device=self.device),
                        "scale": torch.zeros(T, S, self.blocks, 1,
                                             dtype=torch.float32,
                                             device=self.device)}
            return torch.zeros(T, S, self.groups, self.head_dim,
                               dtype=self.dtype, device=self.device)

        return {**{name: [leaf() for _ in range(self.num_layers)]
                   for name in KV_LEAVES},
                "lengths": torch.zeros(S, dtype=torch.int32,
                                       device=self.device)}

    def host_zero_row(self):
        """One slot's zeroed rows in the canonical model layout on the
        host, whatever this spec's tp: K/V ``[max_len, 1, g, d]`` (every
        group) at full precision in either mode (a level of 0 masks every
        position, so the content is never read)."""
        shape = (self.max_len, 1, self.canonical_groups, self.head_dim)
        return {**{name: [torch.zeros(shape, dtype=self.dtype)
                          for _ in range(self.num_layers)]
                   for name in KV_LEAVES},
                "lengths": torch.zeros(1, dtype=torch.int32)}

    def seed_buffer(self, b):
        """Zeroed seed buffer of a ``b``-row bucket on the model's device:
        ``[2, L, max_len, b, g, d]`` in the compute dtype, K at index 0
        and V at 1. A seeded prefill runs in place over it, so after the
        call it holds the bucket's raw merged rows."""
        return torch.zeros(2, self.num_layers, self.max_len, b, self.groups,
                           self.head_dim, dtype=self.dtype,
                           device=self.device)

    @staticmethod
    def seed_cache(buf, lengths):
        """A model-ready :class:`KVCache` over a seed buffer's K/V views,
        each row at its level ``lengths`` (int32 [b], taken as is: the
        forward advances it in place)."""
        return KVCache.from_buffers(list(buf[0]), list(buf[1]), lengths)

    def rank_slice(self, x):
        """This rank's groups of canonical raw K/V ``[..., g, d]``: the
        reshard half of migration (JAX's ``row_pspecs`` in-specs). A
        view."""
        return x[..., self.rank * self.groups:(self.rank + 1) * self.groups,
                 :]

    def seed_rows(self, buf, i, rows, cut, staging):
        """Copy the first ``cut`` positions of the raw rows ``rows`` (a
        host row tree, :meth:`host_zero_row`'s canonical layout, cut to
        this rank's groups) into row ``i`` of
        the seed buffer ``buf``, through ``staging`` (a contiguous device
        tensor of ``buf[:, :, :, 0]``'s shape): one copy a K/V leaf to
        the card without blocking, then one strided copy on the card.
        The host never reads the rows, so a row still being copied from
        the card into pinned memory is read after that copy in stream
        order. The positions from ``cut`` on are not written: the row's
        level is ``cut``, so they stay masked. Returns the bytes
        copied."""
        nbytes = 0
        for k, name in enumerate(KV_LEAVES):
            for layer, x in enumerate(rows[name]):
                src = self.rank_slice(x[:cut, 0])
                staging[k, layer, :cut].copy_(src, non_blocking=True)
                nbytes += src.numel() * src.element_size()
        buf[:, :, :cut, i].copy_(staging[:, :, :cut])
        return nbytes

    def host_raw_rows(self, buf, rows, lengths):
        """Host copies of rows ``rows`` (host ints) of the seed buffer
        ``buf`` after a seeded prefill, each a canonical raw row tree of
        the full ``max_len`` positions with fill level ``lengths[j]``: one
        gather on the card (at tp > 1 then one gather of the groups over
        the ranks) and one copy into pinned memory, without blocking (the
        stream orders any later read of it on the card; a host read must
        synchronize first)."""
        idx = torch.as_tensor(rows, dtype=torch.long, device=buf.device)
        packed = buf.index_select(3, idx).permute(3, 0, 1, 2, 4, 5)
        if self.tp > 1:
            packed = _gather_groups(packed)
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=buf.device.type == "cuda")
        host.copy_(packed, non_blocking=True)
        return [{"keys": [host[j, 0, l][:, None]
                          for l in range(self.num_layers)],
                 "values": [host[j, 1, l][:, None]
                            for l in range(self.num_layers)],
                 "lengths": torch.tensor([int(n)], dtype=torch.int32)}
                for j, n in enumerate(lengths)]

    def consolidate_host_rows(self, rows, tp=1):
        """One slot's store rows in JAX's global view for a ``tp``-rank
        engine (per layer K/V ``[max_len, 1, tp * n, ...]``: the ranks'
        ``n`` groups, or in int8 mode their ``n`` blocks and scales,
        concatenated in rank order; and ``lengths`` [1]) -> canonical raw
        rows in :meth:`host_zero_row`'s layout, on the rows' device:
        each rank's int8 blocks dequantized against its own scales (#15
        on the card) and trimmed of its own pad, the ranks' groups
        concatenated in rank order; bf16 rows copied. The migration
        payload's layout. The per-rank layout is this spec's, so a spec
        built at tp = 1 reads ``tp`` shards of its full width, as JAX's.
        Raises ``ValueError`` when a leaf does not match it."""
        tp = int(tp)
        shape = (self.max_len, 1, tp * self.groups, self.head_dim)

        def fix(name, leaf):
            if self.mode == "int8":
                if not (isinstance(leaf, dict) and "q" in leaf):
                    raise ValueError(
                        f"kv payload leaf {name!r}: expected the int8 "
                        f"layout's q/scale subtree, got "
                        f"{type(leaf).__name__}")
                q, s = leaf["q"], leaf["scale"]
                want = (self.max_len, 1, tp * self.blocks, self.block)
                if tuple(q.shape) != want or q.dtype != torch.int8:
                    raise ValueError(
                        f"kv payload leaf {name!r}: int8 blocks "
                        f"{tuple(q.shape)}/{q.dtype} do not match the "
                        f"tp={tp} layout {want}")
                out = compression.dequantize_rows_blockwise(
                    q.reshape(self.max_len, tp, self.blocks, self.block),
                    s.reshape(self.max_len, tp, self.blocks, 1),
                    n=self.width, out_dtype=self.dtype)
                return out.reshape(shape)
            if tuple(leaf.shape) != shape or leaf.dtype != self.dtype:
                raise ValueError(
                    f"kv payload leaf {name!r}: {tuple(leaf.shape)}/"
                    f"{leaf.dtype} does not match the tp={tp} canonical "
                    f"layout {shape}/{self.dtype}")
            return leaf.clone()

        out = {name: [fix(f"{name}[{l}]", x)
                      for l, x in enumerate(rows[name])]
               for name in KV_LEAVES}
        out["lengths"] = rows["lengths"].to(torch.int32).reshape(1).clone()
        return out

    def global_rows(self, rows):
        """JAX's global view of gathered store rows: every rank's
        shards of each K/V leaf concatenated on the groups (bf16) or
        blocks (int8) axis in rank order, one gather over the tp group a
        kind of leaf; ``rows`` as they are at tp = 1."""
        if self.tp == 1:
            return rows
        L = self.num_layers

        def gathered(leaves):
            out = _gather_groups(torch.stack(leaves))
            return list(out[:L]), list(out[L:])

        both = rows["keys"] + rows["values"]
        if self.mode == "int8":
            qk, qv = gathered([x["q"] for x in both])
            sk, sv = gathered([x["scale"] for x in both])
            keys = [{"q": q, "scale": s} for q, s in zip(qk, sk)]
            values = [{"q": q, "scale": s} for q, s in zip(qv, sv)]
        else:
            keys, values = gathered(both)
        return {"keys": keys, "values": values, "lengths": rows["lengths"]}

    # -- bytes accounting --------------------------------------------------

    def bytes_per_slot(self, *, kv_itemsize=None):
        """Device bytes one slot occupies, counted as the JAX store
        counts them: K/V at ``kv_itemsize`` bytes a lane (default the
        cache's own: the compute dtype's, or in int8 mode one byte a
        lane plus an fp32 scale a block), plus an int32 fill level per
        layer (JAX's per-layer ``cache_index``; the port keeps one level
        a slot, 4 (L - 1) bytes less)."""
        positions = 2 * self.num_layers * self.max_len  # K and V rows
        if kv_itemsize is not None:
            kv = positions * self.width * kv_itemsize
        elif self.mode == "int8":
            kv = positions * self.blocks * (self.block + 4)
        else:
            kv = positions * self.width * self.dtype.itemsize
        return kv + 4 * self.num_layers

    def total_bytes(self, **kw):
        return self.num_slots * self.bytes_per_slot(**kw)

    def cache_dtype_name(self):
        return "int8" if self.mode == "int8" else str(self.dtype).split(".")[-1]

    # -- slot rows ---------------------------------------------------------

    def gather_rows(self, store, slot_ids):
        """The rows of ``slot_ids`` (int64 [b] on the store's device), a
        copy: per layer ``[max_len, b, ...]`` and ``lengths`` [b]."""
        rows = _map_kv(lambda t: t.index_select(1, slot_ids), store)
        rows["lengths"] = store["lengths"].index_select(0, slot_ids)
        return rows

    def scatter_rows(self, store, slot_ids, rows):
        """Write ``rows`` back into ``slot_ids`` of ``store`` (in place);
        the other slots' rows are not touched."""
        for name in KV_LEAVES:
            for dst, src in zip(store[name], rows[name]):
                if isinstance(dst, dict):
                    dst["q"].index_copy_(1, slot_ids, src["q"])
                    dst["scale"].index_copy_(1, slot_ids, src["scale"])
                else:
                    dst.index_copy_(1, slot_ids, src)
        store["lengths"].index_copy_(0, slot_ids, rows["lengths"])

    @staticmethod
    def keep_rows(rows, keep):
        """``rows`` with the rows where ``keep`` [b] is False zeroed, their
        fill levels too (the quarantine of a non-finite slot)."""
        def fix(t):
            mask = keep.reshape((1, -1) + (1,) * (t.dim() - 2))
            return torch.where(mask, t, torch.zeros((), dtype=t.dtype,
                                                    device=t.device))
        out = _map_kv(fix, rows)
        out["lengths"] = torch.where(keep, rows["lengths"], 0).to(
            torch.int32)
        return out

    # -- store <-> model-row conversion ------------------------------------

    def materialize_rows(self, rows):
        """Gathered store rows -> a model-ready :class:`KVCache` (K/V in
        the compute dtype, dequantized on read in int8 mode; the bf16
        mode's buffers are the rows themselves). The cache's fill levels
        are ``rows["lengths"]``, advanced in place by a forward."""
        if self.mode != "int8":
            return KVCache.from_buffers(rows["keys"], rows["values"],
                                        rows["lengths"])

        def dense(leaf):
            T, b = leaf["q"].shape[:2]
            out = compression.dequantize_rows_blockwise(
                leaf["q"], leaf["scale"], n=self.width, out_dtype=self.dtype)
            return out.reshape(T, b, self.groups, self.head_dim)

        return KVCache.from_buffers([dense(x) for x in rows["keys"]],
                                    [dense(x) for x in rows["values"]],
                                    rows["lengths"])

    def quantize_rows(self, cache):
        """A model-ready :class:`KVCache` -> store rows (a full-row
        quantize in int8 mode). Only right for fresh rows (the admission
        prefill): every position gets new scales; the decode path uses
        :meth:`update_rows_at` instead."""
        if self.mode != "int8":
            return {"keys": cache.keys, "values": cache.values,
                    "lengths": cache.lengths}

        def quant(x):
            T, b = x.shape[:2]
            q, s = compression.quantize_rows_blockwise(
                x.reshape(T, b, self.width), self.block)
            return {"q": q, "scale": s}

        return {"keys": [quant(x) for x in cache.keys],
                "values": [quant(x) for x in cache.values],
                "lengths": cache.lengths}

    def update_rows_span(self, store_rows, cache, start, span):
        """Merge a ``span``-position K/V append back into gathered store
        rows, in place. ``cache`` is the model-ready cache after the
        forward (row i written at positions ``[start[i], start[i] +
        span)``, ``start`` int [b] on the device); in int8 mode only those
        positions are (re)quantized and every other block's codes and
        scale stay bit-identical (positions past the buffer are not
        written, as JAX's select leaves them). The fill levels become the
        cache's. bf16 mode returns the cache's rows. Returns the rows."""
        if self.mode != "int8":
            return self.quantize_rows(cache)
        span = int(span)
        b = start.shape[0]
        device = start.device
        # positions past the buffer fold onto its last row, which they
        # then write with that row's own value (the same as its valid
        # entry writes), or, where the whole span lies past the buffer
        # (a padding slot of a bucket), with the old codes: no entry
        # changes a position outside [start, start + span)
        pos = (start.long()[None, :] + torch.arange(span, device=device
                                                    )[:, None]
               ).clamp(max=self.max_len - 1)  # [span, b]
        live = (start < self.max_len)[None, :, None, None]
        cols = torch.arange(b, device=device)[None, :].expand(span, b)
        for name in KV_LEAVES:
            for leaf, x in zip(store_rows[name], getattr(cache, name)):
                sel = x[pos, cols].reshape(span, b, self.width)
                q, s = compression.quantize_rows_blockwise(sel, self.block)
                old_q, old_s = leaf["q"][pos, cols], leaf["scale"][pos, cols]
                leaf["q"][pos, cols] = torch.where(live, q, old_q)
                leaf["scale"][pos, cols] = torch.where(live, s, old_s)
        store_rows["lengths"] = cache.lengths
        return store_rows

    def update_rows_at(self, store_rows, cache, positions):
        """Merge one decode step's K/V append back into gathered store
        rows: :meth:`update_rows_span` with a span of 1 at each row's
        ``positions[i]``."""
        return self.update_rows_span(store_rows, cache, positions, 1)

    # -- per-block parity bound --------------------------------------------

    def quantization_bound(self, kv_absmax):
        """Worst-case per-lane dequantization error for a block whose
        absmax is ``kv_absmax``: half a grid step, ``absmax / 254``."""
        return float(kv_absmax) / (2.0 * 127.0)
