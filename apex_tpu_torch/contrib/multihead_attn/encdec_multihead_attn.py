"""Encoder-decoder multi-head attention (counterpart of
``apex_tpu/contrib/multihead_attn/encdec_multihead_attn.py``): Q from
the decoder stream, a fused KV projection from the encoder stream;
with ``include_norm_add``, a pre-LayerNorm (``lyr_norm``) of the query
and the residual add of the query after the output projection.

Parameters keep the JAX names and [in, out] layouts (``q_weight`` [h,
h], ``kv_weight`` [h, 2h], ``out_proj_weight``, and the biases). Under
JAX's condition (no mask, equal query and key lengths, no live dropout;
``impl`` is not consulted, as in JAX) the core is the non-causal flash
attention of :mod:`apex_tpu_torch.contrib.fmha`; otherwise the einsum
path with a boolean ``attn_mask``.
"""

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn import _core


class EncdecMultiheadAttn(nn.Module):
    """``forward(query [sq, b, h], key [sk, b, h])`` -> [sq, b, h]
    (``value`` is unused: K and V both come from ``key``). Masks,
    ``is_training`` and ``generator`` as in
    :class:`~apex_tpu_torch.contrib.multihead_attn.SelfMultiheadAttn`."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 param_dtype=torch.float32, device=None):
        super().__init__()
        _core.check_args(embed_dim, num_heads, dropout, impl)
        device = resolve_device(device)
        self.include_norm_add = include_norm_add
        self.lyr_norm = _core.norm(include_norm_add, embed_dim, device)
        h = embed_dim
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias, self.impl = dropout, bias, impl
        self.q_weight = _core.weight(h, h, param_dtype, device)
        self.kv_weight = _core.weight(h, 2 * h, param_dtype, device)
        self.out_proj_weight = _core.weight(h, h, param_dtype, device)
        if bias:
            self.q_bias = _core.bias(h, param_dtype, device)
            self.kv_bias = _core.bias(2 * h, param_dtype, device)
            self.out_proj_bias = _core.bias(h, param_dtype, device)
        else:
            self.q_bias = self.kv_bias = self.out_proj_bias = None

    def forward(self, query, key, value=None, key_padding_mask=None,
                need_weights=False, attn_mask=None, is_training=None,
                generator=None):
        training = self.training if is_training is None else is_training
        residual = query
        query = _core.pre_norm(self.lyr_norm, query)
        q = _core.project(query, self.q_weight, self.q_bias)
        k, v = _core.project(key, self.kv_weight, self.kv_bias).chunk(2, -1)
        drop = self.dropout if training else 0.0
        use_flash = (attn_mask is None and key_padding_mask is None
                     and query.shape[0] == key.shape[0] and drop == 0)
        nh = self.num_heads
        scale = 1.0 / (self.embed_dim // nh) ** 0.5
        ctx = _core.attend(
            _core.to_heads(q, nh), _core.to_heads(k, nh),
            _core.to_heads(v, nh), scale, use_flash,
            query.dtype, attn_mask, key_padding_mask, False, drop, generator)
        out = _core.project(_core.from_heads(ctx), self.out_proj_weight,
                            self.out_proj_bias)
        if self.include_norm_add:
            out = out + residual
        return (out, None) if need_weights else out
