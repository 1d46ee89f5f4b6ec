"""The KV cache of a decoder LM.

Counterpart of the flax ``cache`` collection that
``apex_tpu.models.transformer_lm.ParallelAttention`` creates in decode
mode: per layer, ``cached_key`` and ``cached_value`` buffers of shape
[max_len, b, g, d] in ``compute_dtype`` holding rotated K/V at group
granularity, and the number of filled rows (``cache_index``). JAX keeps
one scalar index per layer, all equal, and the serving engine vmaps the
model over slots so that each slot has its own. Here one int32 [b]
tensor on the cache's device, :attr:`KVCache.lengths`, holds every
row's fill level: the rows of one batch may sit at different levels
(the serving engine's slots), each row's chunk is written at its own
level and attends up to its own position. The model advances the levels
after all its layers have written their rows; the buffers are updated
in place.

``index`` is the host's copy of the level while every row shares one
(``generate``), so that a chunk that would overflow the buffers is
refused before it runs; after :meth:`KVCache.set_lengths` with a device
tensor it is None and the caller bounds the levels (the serving
engine's admission does). Writes past ``max_len`` are clamped as JAX's
``dynamic_update_slice`` clamps them.

Beam search and shared prefixes move whole rows along the batch axis:
:meth:`KVCache.reorder` (the rows a beam step keeps),
:meth:`KVCache.repeat_rows` (each row ``k`` times, as ``jnp.repeat(x, k,
axis=1)``) and :meth:`KVCache.broadcast_rows` (a batch-1 cache copied to
batch ``b``) each return a new cache over new buffers, never a view, so
that a later write in place touches only that cache.

Under a tp grid each rank's cache holds its own ``groups / tp`` groups
(:func:`local_groups`), the heads its attention computes.
"""

import torch

from apex_tpu_torch.transformer.parallel_state import (
    get_tensor_model_parallel_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide


def local_groups(config) -> int:
    """The K/V groups one rank of the tp grid holds: ``query_groups /
    tp`` of a :class:`~apex_tpu_torch.models.TransformerConfig`."""
    return divide(config.query_groups, get_tensor_model_parallel_world_size())


class KVCache:
    """Per-layer K/V buffers [max_len, batch, groups, head_dim] and each
    row's count of filled rows, on one device."""

    def __init__(self, num_layers, max_len, batch, groups, head_dim, dtype,
                 device):
        shape = (max_len, batch, groups, head_dim)
        self.keys = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(num_layers)]
        self.values = [torch.zeros(shape, dtype=dtype, device=device)
                       for _ in range(num_layers)]
        self.max_len = max_len
        self.lengths = torch.zeros(batch, dtype=torch.int32, device=device)
        self.index = 0
        self._chunk = None

    @classmethod
    def from_buffers(cls, keys, values, lengths):
        """A cache over existing per-layer buffers [max_len, b, g, d] (not
        copied) with fill levels ``lengths`` (int32 [b] on their device)."""
        cache = cls.__new__(cls)
        cache.keys, cache.values = list(keys), list(values)
        cache.max_len = keys[0].shape[0]
        cache.lengths = lengths
        cache.index = None
        cache._chunk = None
        return cache

    @property
    def batch(self):
        return self.lengths.shape[0]

    def check_room(self, s):
        """Raise unless ``s`` more rows fit (checked while the host knows
        the level)."""
        if self.index is not None and self.index + s > self.max_len:
            raise ValueError(f"KV cache full: {self.index} rows + {s} new "
                             f"exceed max_len {self.max_len}")

    def chunk(self, s):
        """Index tensors for a chunk of ``s`` tokens, shared by every
        layer of one forward (made once, until the levels move): the
        tokens' absolute positions [s, b] (each row's level onward), the
        rows [s, b] and columns [s, b] its K/V are written at (the same,
        the start clamped so the chunk fits, as JAX's
        ``dynamic_update_slice``) and each row's live length after the
        chunk (int32 [b])."""
        if self._chunk == s:
            return
        self.check_room(s)
        device = self.lengths.device
        steps = torch.arange(s, device=device)[:, None]
        self.positions = self.lengths[None, :].long() + steps
        start = self.lengths.clamp(max=self.max_len - s)
        self.write_rows = start[None, :].long() + steps
        self.write_cols = torch.arange(self.batch,
                                       device=device)[None, :].expand(s, -1)
        self.live = self.lengths + s
        self._chunk = s

    def advance(self, s):
        self.check_room(s)
        self.lengths += s
        if self.index is not None:
            self.index += s
        self._chunk = None

    def set_lengths(self, lengths):
        """Roll every row's level to ``lengths`` (a host int, or an
        integer tensor [b] on the cache's device): rows past a level stay
        resident but masked, since attention masks by absolute position
        (a speculative rollback or a padded prefill's true length)."""
        if isinstance(lengths, torch.Tensor):
            self.lengths.copy_(lengths)
            self.index = None
        else:
            self.lengths.fill_(int(lengths))
            self.index = int(lengths)
        self._chunk = None

    def _with_rows(self, fn):
        """A new cache whose buffers and levels are ``fn`` of this one's
        (along the batch axis), with this cache's host level."""
        cache = KVCache.from_buffers([fn(k, 1) for k in self.keys],
                                     [fn(v, 1) for v in self.values],
                                     fn(self.lengths, 0))
        cache.index = self.index
        return cache

    def reorder(self, index):
        """A new cache holding row ``index[i]`` of this one at row i
        (``index`` int64 [b'] on the cache's device)."""
        return self._with_rows(lambda t, ax: t.index_select(ax, index))

    def repeat_rows(self, k: int):
        """A new cache with each row repeated ``k`` times in place:
        rows 0, 0, .., 1, 1, .. (batch b * k)."""
        return self._with_rows(
            lambda t, ax: t.repeat_interleave(int(k), dim=ax))

    def broadcast_rows(self, b: int):
        """A new cache of batch ``b`` over a real copy of this one's rows:
        a batch-1 cache broadcast to every row (a batch-b cache copied),
        JAX's ``_broadcast_prefix_cache`` for ``generate(prefix_state=)``.
        Raises ``ValueError`` for any other batch."""
        if self.batch not in (1, b):
            raise ValueError(f"prefix cache batch ({self.batch}) != prompt "
                             f"batch ({b}); only batch-1 prefixes "
                             f"broadcast")
        return self._with_rows(lambda t, ax: t.expand(
            *t.shape[:ax], b, *t.shape[ax + 1:]).clone(
                memory_format=torch.contiguous_format))
