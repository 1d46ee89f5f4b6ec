"""The KV cache of a decoder LM.

Counterpart of the flax ``cache`` collection that
``apex_tpu.models.transformer_lm.ParallelAttention`` creates in decode
mode: per layer, ``cached_key`` and ``cached_value`` buffers of shape
[max_len, b, g, d] in ``compute_dtype`` holding rotated K/V at group
granularity, and the number of filled rows (``cache_index``). JAX keeps
one index per layer, all equal; here the model advances one index after
all its layers have written their rows. The buffers are updated in
place.
"""

import torch


class KVCache:
    """Per-layer K/V buffers [max_len, batch, groups, head_dim] and the
    count of filled rows, on one device."""

    def __init__(self, num_layers, max_len, batch, groups, head_dim, dtype,
                 device):
        shape = (max_len, batch, groups, head_dim)
        self.keys = [torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(num_layers)]
        self.values = [torch.zeros(shape, dtype=dtype, device=device)
                       for _ in range(num_layers)]
        self.max_len = max_len
        self.index = 0

    def check_room(self, s):
        """Raise unless ``s`` more rows fit."""
        if self.index + s > self.max_len:
            raise ValueError(f"KV cache full: {self.index} rows + {s} new "
                             f"exceed max_len {self.max_len}")

    def advance(self, s):
        self.check_room(s)
        self.index += s
