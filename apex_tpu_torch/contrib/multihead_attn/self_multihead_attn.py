"""Self multi-head attention (counterpart of
``apex_tpu/contrib/multihead_attn/self_multihead_attn.py``).

A fused QKV projection (or three with ``separate_qkv_params``), the
attention core, and the output projection, over the reference [s, b, h]
layout; with ``include_norm_add``, a pre-LayerNorm (``lyr_norm``) of
the query and the residual add of the input after the projection.
Parameters keep the JAX names and [in, out] layouts (``qkv_weight`` [h,
3h] or ``q_weight``/``k_weight``/``v_weight``, ``out_proj_weight``, the
biases and ``lyr_norm``'s), so ``models.from_jax_params``
carries a flax tree over as it is. Under JAX's condition (no mask,
``impl="fast"``, no live dropout) the core is the non-causal flash
attention of :mod:`apex_tpu_torch.contrib.fmha`; otherwise fp32 einsum
scores, masks, softmax and dropout.
"""

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib.multihead_attn import _core


class SelfMultiheadAttn(nn.Module):
    """``forward(query [s, b, h])`` -> [s, b, h] (``(out, None)`` with
    ``need_weights``). ``attn_mask`` [sq, sk]: True masks (or, with
    ``mask_additive``, is added to the scores); ``key_padding_mask``
    [b, sk]: True masks. ``is_training`` (default: the module's
    ``training``) turns dropout on; its draws come from ``generator``.
    ``include_norm_add=True`` gives ``query + attn(lyr_norm(query))``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 separate_qkv_params=False, mask_additive=False,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        _core.check_args(embed_dim, num_heads, dropout, impl)
        device = resolve_device(device)
        self.include_norm_add = include_norm_add
        self.lyr_norm = _core.norm(include_norm_add, embed_dim, device)
        h = embed_dim
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias, self.impl = dropout, bias, impl
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive = mask_additive
        names = ("q", "k", "v") if separate_qkv_params else ("qkv",)
        width = h if separate_qkv_params else 3 * h
        for name in names:
            setattr(self, f"{name}_weight",
                    _core.weight(h, width, param_dtype, device))
            if bias:
                setattr(self, f"{name}_bias",
                        _core.bias(width, param_dtype, device))
        self.out_proj_weight = _core.weight(h, h, param_dtype, device)
        self.out_proj_bias = (_core.bias(h, param_dtype, device) if bias
                              else None)

    def _proj(self, name, x):
        return _core.project(x, getattr(self, f"{name}_weight"),
                             getattr(self, f"{name}_bias", None))

    def forward(self, query, key=None, value=None, key_padding_mask=None,
                need_weights=False, attn_mask=None, is_training=None,
                generator=None):
        training = self.training if is_training is None else is_training
        residual = query
        query = _core.pre_norm(self.lyr_norm, query)
        if self.separate_qkv_params:
            q, k, v = (self._proj(name, query) for name in ("q", "k", "v"))
        else:
            q, k, v = self._proj("qkv", query).chunk(3, dim=-1)
        drop = self.dropout if training else 0.0
        use_flash = (attn_mask is None and key_padding_mask is None
                     and self.impl == "fast" and drop == 0)
        nh = self.num_heads
        scale = 1.0 / (self.embed_dim // nh) ** 0.5
        ctx = _core.attend(
            _core.to_heads(q, nh), _core.to_heads(k, nh),
            _core.to_heads(v, nh), scale, use_flash,
            query.dtype, attn_mask, key_padding_mask, self.mask_additive,
            drop, generator)
        out = _core.project(_core.from_heads(ctx), self.out_proj_weight,
                            self.out_proj_bias)
        if self.include_norm_add:
            out = out + residual
        return (out, None) if need_weights else out
