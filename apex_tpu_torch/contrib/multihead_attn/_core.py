"""What the two multi-head attention modules share: JAX's promoting
``x @ w``, the head split, the einsum attention path (masks, dropout),
and ``include_norm_add``'s pre-LayerNorm."""

import torch
from torch import nn

from apex_tpu_torch.contrib.fmha import flash_attention
from apex_tpu_torch.normalization import FusedLayerNorm

MASK_VALUE = -10000.0  # the reference module's masked score


def check_args(embed_dim, num_heads, dropout, impl):
    if embed_dim % num_heads:
        raise ValueError(f"embed_dim ({embed_dim}) must be a multiple of "
                         f"num_heads ({num_heads})")
    if not 0.0 <= dropout <= 1.0:
        raise ValueError(f"dropout ({dropout}) must be in [0, 1]")
    if impl not in ("fast", "default"):
        raise ValueError(f"impl must be 'fast' or 'default', got {impl!r}")


def norm(include_norm_add, embed_dim, device):
    """``lyr_norm``, the pre-LayerNorm of ``include_norm_add`` (fp32
    parameters, eps 1e-5), or None."""
    return FusedLayerNorm(embed_dim, device=device) if include_norm_add else None


def pre_norm(lyr_norm, query):
    """The query normalised in fp32 and cast back to its dtype, as the
    JAX modules do; the query itself without ``include_norm_add``."""
    if lyr_norm is None:
        return query
    return lyr_norm(query.float()).to(query.dtype)


def weight(rows, cols, dtype, device):
    """A [rows, cols] ([in, out]) parameter, xavier-uniform as in flax."""
    w = torch.empty(rows, cols, dtype=dtype, device=device)
    return nn.Parameter(nn.init.xavier_uniform_(w))


def bias(n, dtype, device):
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


def project(x, w, b=None):
    """``x @ w (+ b)`` with JAX's type promotion: a bf16 input and an fp32
    weight give an fp32 product."""
    dt = torch.promote_types(x.dtype, w.dtype)
    out = torch.matmul(x.to(dt), w.to(dt))
    return out if b is None else out + b


def to_heads(x, heads):
    """[s, b, h] -> [b, heads, s, h / heads]."""
    s, b, h = x.shape
    return x.reshape(s, b, heads, h // heads).permute(1, 2, 0, 3)


def from_heads(ctx):
    """[b, heads, s, d] -> [s, b, heads * d]."""
    b, n, s, d = ctx.shape
    return ctx.permute(2, 0, 1, 3).reshape(s, b, n * d)


def dropout(p, rate, generator):
    """flax's Dropout: keep each entry with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate); the draws come from ``generator``."""
    if rate >= 1.0:
        return torch.zeros_like(p)
    keep = torch.rand(p.shape, generator=generator, device=p.device) >= rate
    return torch.where(keep, p / (1.0 - rate), 0.0)


def attend(qh, kh, vh, scale, use_flash, out_dtype, attn_mask=None,
           key_padding_mask=None, mask_additive=False, drop=0.0,
           generator=None):
    """The attention core: non-causal flash attention (in q's dtype), or
    fp32 einsum scores with the boolean mask (True = masked, -10000) or
    the additive one, the key padding mask, an fp32 softmax, dropout at
    rate ``drop``, and the context in ``out_dtype``."""
    if use_flash:
        return flash_attention(qh, kh, vh, False, scale)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if attn_mask is not None:
        if mask_additive:
            scores = scores + attn_mask.float()
        else:
            scores = scores.masked_fill(attn_mask.bool(), MASK_VALUE)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask.bool()[:, None, None, :],
                                    MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if drop > 0:
        probs = dropout(probs, drop, generator)
    return torch.matmul(probs, vh.float()).to(out_dtype)
