"""Megatron-style transformer blocks: the KV-cache decode path and the
training forward.

Counterpart of ``apex_tpu/models/transformer_lm.py``: pre-norm layers
(LayerNorm or RMSNorm) over the Megatron [s, b, h] layout, a fused QKV
projection, and learned positions (added by the model below the stack)
or RoPE (applied here).

- With a KV cache (``ParallelTransformer(decode=True)`` in JAX): RoPE at
  absolute positions where the model uses it, the cache written in
  place, and attention through
  :func:`apex_tpu_torch.kernels.fused_cc.window_attention` for a chunk
  of several tokens (the prompt) or
  :func:`apex_tpu_torch.contrib.gqa_decode.gqa_flash_decode` for each
  single-token step.
- Without one, the training forward. Under the JAX model's condition
  (``use_flash_attention``, no ``attention_mask``, no softcap,
  ``query_pre_attn_scalar`` unset or the head dim, a sequence that is a
  multiple of 128 and a head dim of 64, 128 or 256): K/V repeated for
  their query heads and :func:`apex_tpu_torch.contrib.fmha.flash_attention`
  over ``[b, n, s, d]`` (causal or full, with the layer's sliding window
  when it is shorter than the sequence). The JAX package also asks that
  its backend be a TPU, so on the CPU it never takes flash; the port
  mirrors what it does on its accelerator and takes flash on the CPU too
  (through the kernels' plain versions). Otherwise the softmax path:
  fp32 scores from the ``compute_dtype`` operands; a window shorter than
  the sequence folded into the mask; the causal softmax kernel for the
  causal mask type without a mask, else the masked softmax kernel (the
  scaled one when there is no mask), forward and backward, of
  :mod:`apex_tpu_torch.transformer.functional`; the context product in
  fp32.

Norms go through the LayerNorm or RMSNorm kernels (forward, and
backward-dx under autograd). Dtypes follow the JAX modules: parameters
in ``params_dtype`` (fp32), activations and the cache in
``compute_dtype``, norm statistics, RoPE, scores, softmax and the MLP's
activation in fp32. The ALiBi/MoE variants are later slices.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib import fmha, gqa_decode
from apex_tpu_torch.kernels import fused_cc
from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import (
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Frequency-rescaled RoPE (HF modeling_rope_utils semantics):
    ``"linear"`` divides every inverse frequency by ``factor``;
    ``"llama3"`` (Llama-3.1) keeps short wavelengths, divides long ones by
    ``factor`` and interpolates in between."""

    rope_type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


def _scale_rope_freqs(inv, scaling: RopeScaling):
    if scaling.rope_type == "linear":
        return inv / scaling.factor
    if scaling.rope_type != "llama3":
        raise ValueError(f"unknown rope_type {scaling.rope_type!r}")
    old_len = scaling.original_max_position_embeddings
    low_wavelen = old_len / scaling.low_freq_factor
    high_wavelen = old_len / scaling.high_freq_factor
    wavelen = 2 * math.pi / inv
    scaled = torch.where(wavelen > low_wavelen, inv / scaling.factor, inv)
    smooth = ((old_len / wavelen - scaling.low_freq_factor)
              / (scaling.high_freq_factor - scaling.low_freq_factor))
    smoothed = (1 - smooth) * scaled / scaling.factor + smooth * scaled
    medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return torch.where(medium, smoothed, scaled)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of ``apex_tpu.models.TransformerConfig`` that the decode
    path and the training forward read, with torch dtypes and JAX's
    defaults (the GPT-2 family: learned positions, gelu, LayerNorm).
    ALiBi positions, which the port cannot run yet, are refused."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    ffn_hidden_size: Optional[int] = None
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    layernorm_epsilon: float = 1e-5
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    use_flash_attention: bool = True
    attn_mask_type: AttnMaskType = AttnMaskType.causal
    num_query_groups: Optional[int] = None
    position_embedding_type: str = "learned"
    rotary_base: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    rotary_percent: float = 1.0
    rotary_interleaved: bool = False
    activation: str = "gelu"
    head_dim: Optional[int] = None
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 1
    attn_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    normalization: str = "layernorm"
    tie_word_embeddings: bool = False

    def __post_init__(self):
        if self.position_embedding_type == "alibi":
            raise NotImplementedError(
                "position_embedding_type 'alibi' is not ported yet (it "
                "needs an ALiBi path in the decode kernels and on the "
                "softmax path; the flash kernels take slopes: "
                "contrib.fmha.flash_attention(alibi_slopes=...))")
        if self.position_embedding_type not in ("learned", "rope"):
            raise ValueError(f"unknown position_embedding_type "
                             f"{self.position_embedding_type!r}")
        if self.normalization not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"unknown normalization {self.normalization!r}")
        if self.activation not in ("gelu", "gelu_exact", "relu", "relu2",
                                   "swiglu", "geglu"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.sliding_window is not None:
            if self.sliding_window < 1:
                raise ValueError(
                    f"sliding_window ({self.sliding_window}) must be >= 1")
            if self.attn_mask_type != AttnMaskType.causal:
                raise ValueError("sliding_window requires causal attention")
        if self.sliding_window_pattern < 1:
            raise ValueError(f"sliding_window_pattern "
                             f"({self.sliding_window_pattern}) must be >= 1")
        if (self.attn_logit_softcapping is not None
                and self.attn_logit_softcapping <= 0):
            raise ValueError(f"attn_logit_softcapping "
                             f"({self.attn_logit_softcapping}) must be > 0")
        if not 0.0 < self.rotary_percent <= 1.0:
            raise ValueError(
                f"rotary_percent ({self.rotary_percent}) must be in (0, 1]")
        if self.num_attention_heads % self.query_groups:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must be a "
                f"multiple of num_query_groups ({self.query_groups})")

    @property
    def ffn_size(self):
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def kv_channels(self):
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def query_groups(self):
        return self.num_query_groups or self.num_attention_heads


def apply_rotary_emb(x, base: float = 10000.0, positions=None,
                     percent: float = 1.0, interleaved: bool = False,
                     scaling: Optional[RopeScaling] = None):
    """Rotary position embedding on [s, b, n, d] (rotate-half convention,
    or GPT-J's interleaved pairs). ``positions`` is [s] or [s, b]
    (default 0..s-1); fp32 trig, cast back to x's dtype. ``percent`` < 1
    rotates only the leading dims of each head (GPT-NeoX rotary_pct)."""
    d_full = x.shape[-1]
    if percent < 1.0:
        rot_n = int(d_full * percent + 1e-6)
        width = 2 * ((rot_n + 1) // 2)
        out = _rope_core(x[..., :width], base, positions, rot_n,
                         interleaved, scaling)
        return torch.cat([out, x[..., width:]], dim=-1)
    return _rope_core(x, base, positions, d_full, interleaved, scaling)


def _rope_core(x, base, positions, freq_dim, interleaved=False,
               scaling=None):
    s = x.shape[0]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    exponents = torch.arange(0, freq_dim, 2, dtype=torch.float32,
                             device=x.device) / freq_dim
    inv = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                       device=x.device), exponents)
    if scaling is not None:
        inv = _scale_rope_freqs(inv, scaling)
    freqs = positions[..., None].float() * inv  # [s(, b), d/2]
    if freqs.dim() == 2:
        freqs = freqs[:, None, :]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape)
    else:
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _make_norm(cfg, device):
    norm = FusedRMSNorm if cfg.normalization == "rmsnorm" else FusedLayerNorm
    return norm(cfg.hidden_size, eps=cfg.layernorm_epsilon, device=device)


def _rotate(cfg, x, positions):
    """RoPE at ``positions`` where the model uses it; x as it is
    otherwise (learned positions are added below the stack)."""
    if cfg.position_embedding_type != "rope":
        return x
    return apply_rotary_emb(x, cfg.rotary_base, positions, cfg.rotary_percent,
                            cfg.rotary_interleaved, cfg.rope_scaling)


class ParallelAttention(nn.Module):
    """Self-attention: fused QKV projection (columns ``[q heads |
    per-group (k_g | v_g)]`` under GQA, per-head ``[q_i | k_i | v_i]``
    blocks under MHA), RoPE, attention, and the output projection. With
    a KV cache, the chunk's K/V are written at the cache's index and the
    window kernel (s > 1) or the decode kernel (s == 1) attends over the
    filled prefix; without one, the training forward attends over the
    chunk through flash attention or the causal softmax kernel."""

    def __init__(self, config: TransformerConfig, layer_number: int = 0,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.layer_number = layer_number
        kv = cfg.kv_channels
        if cfg.query_groups == cfg.num_attention_heads:
            width = 3 * cfg.num_attention_heads * kv
        else:
            width = (cfg.num_attention_heads + 2 * cfg.query_groups) * kv
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, width, bias=True, params_dtype=cfg.params_dtype,
            device=device)
        self.dense = RowParallelLinear(
            cfg.num_attention_heads * kv, cfg.hidden_size, bias=True,
            params_dtype=cfg.params_dtype, device=device)

    def _layer_window(self):
        """This layer's sliding window, or None (every
        sliding_window_pattern-th layer runs full causal attention)."""
        cfg = self.config
        if cfg.sliding_window is None:
            return None
        if (cfg.sliding_window_pattern > 1
                and (self.layer_number + 1) % cfg.sliding_window_pattern == 0):
            return None
        return cfg.sliding_window

    def forward(self, hidden_states, position_ids=None, cache=None,
                attention_mask=None):
        cfg = self.config
        n = cfg.num_attention_heads
        kv = cfg.kv_channels
        s, b = hidden_states.shape[:2]
        proj = self.query_key_value(hidden_states.to(cfg.compute_dtype))
        if cfg.query_groups == n:
            q, k, v = proj.reshape(s, b, n, 3 * kv).split(kv, dim=-1)
        else:
            g = cfg.query_groups
            q = proj[..., :n * kv].reshape(s, b, n, kv)
            k, v = proj[..., n * kv:].reshape(s, b, g, 2 * kv).split(kv,
                                                                    dim=-1)
        if cache is not None:
            if attention_mask is not None:
                raise ValueError(
                    "decode mode does not support attention_mask: batch "
                    "unpadded prompts (left-trim or group by length)")
            return self._decode_attention(q, k, v, position_ids, cache)
        return self._train_attention(q, k, v, position_ids, attention_mask)

    def _flash(self, s, attention_mask):
        """Whether the training forward takes flash attention: the JAX
        model's condition, its backend test left out."""
        cfg = self.config
        return (cfg.use_flash_attention and attention_mask is None
                and cfg.attn_logit_softcapping is None
                and cfg.query_pre_attn_scalar in (None, cfg.kv_channels)
                and _flash_available(s, cfg.kv_channels))

    def _train_attention(self, q, k, v, position_ids, attention_mask):
        """Attention over the chunk, as the JAX model's training forward:
        RoPE at ``position_ids`` (default 0..s-1) where the model uses
        it, each K/V group repeated for its query heads, then flash
        attention (see :meth:`_flash`) or the softmax path: fp32 scores
        from ``compute_dtype`` operands, a window shorter than the
        sequence folded into ``attention_mask`` (True = masked), the
        causal softmax kernel for the causal mask type without a mask,
        else the masked (or, with no mask, the scaled) softmax kernel,
        the context product in fp32 from ``compute_dtype``
        probabilities. The ``.float()`` casts make the bf16 x bf16
        products accumulate in fp32 and send the operands' gradients
        back in their own dtype, as JAX's einsum with
        ``preferred_element_type=float32`` does."""
        cfg = self.config
        s, b, n, kv = q.shape
        q = _rotate(cfg, q, position_ids)
        k = _rotate(cfg, k, position_ids)
        if k.shape[2] != n:  # head i reads group i // rep
            rep = n // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        window = self._layer_window()
        if window is not None and window >= s:
            window = None  # a window covering the sequence is plain causal
        if self._flash(s, attention_mask):
            # q, k, v as the projection left them (fp32 after its bias,
            # as in JAX), [s, b, n, d] -> [b, n, s, d]
            ctx = fmha.flash_attention(
                *(t.permute(1, 2, 0, 3) for t in (q, k, v)),
                causal=cfg.attn_mask_type == AttnMaskType.causal,
                window=window)
        else:
            if window is not None:
                i = torch.arange(s, device=q.device)[:, None]
                j = torch.arange(s, device=q.device)[None, :]
                band = (j > i) | (i - j >= window)
                attention_mask = (band if attention_mask is None
                                  else band | attention_mask.bool())
            qt, kt, vt = (t.permute(1, 2, 0, 3).to(cfg.compute_dtype)
                          for t in (q, k, v))
            scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2))
            scores = scores / math.sqrt(cfg.query_pre_attn_scalar or kv)
            if cfg.attn_logit_softcapping is not None:
                cap = cfg.attn_logit_softcapping
                scores = cap * torch.tanh(scores / cap)
            if (cfg.attn_mask_type == AttnMaskType.causal
                    and attention_mask is None):
                probs = scaled_upper_triang_masked_softmax(
                    scores.reshape(b * n, s, s), 1.0).reshape(b, n, s, s)
            else:
                probs = scaled_masked_softmax(scores, attention_mask, 1.0)
            ctx = torch.matmul(probs.to(cfg.compute_dtype).float(),
                               vt.float())
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, n * kv)
        return self.dense(ctx.to(cfg.compute_dtype))

    def _decode_attention(self, q, k, v, position_ids, cache):
        """Rotate at absolute positions (RoPE models), write the chunk's
        rows at the cache's index, attend over the filled prefix."""
        cfg = self.config
        s, b, n, kv = q.shape
        n_kv = k.shape[2]
        rep = n // n_kv
        idx = cache.index
        pos = (position_ids if position_ids is not None
               else idx + torch.arange(s, device=q.device))
        q = _rotate(cfg, q, pos)
        k = _rotate(cfg, k, pos)
        ck = cache.keys[self.layer_number]
        cv = cache.values[self.layer_number]
        ck[idx:idx + s] = k
        cv[idx:idx + s] = v
        qg = q.reshape(s, b, n_kv, rep, kv).to(cfg.compute_dtype).contiguous()
        sm = 1.0 / math.sqrt(cfg.query_pre_attn_scalar or kv)
        if s == 1:
            ctx = gqa_decode.gqa_flash_decode(
                qg[0], ck, cv, idx + 1, sm, window=self._layer_window(),
                softcap=cfg.attn_logit_softcapping)
        else:
            ctx = fused_cc.window_attention(
                qg, ck, cv, idx, sm, window=self._layer_window(),
                softcap=cfg.attn_logit_softcapping)
        return self.dense(ctx.reshape(s, b, n * kv).to(cfg.compute_dtype))


def _flash_available(seq, head_dim):
    """JAX's ``_flash_available`` without its backend test."""
    return seq % 128 == 0 and head_dim in fmha.HEAD_DIMS


class ParallelMLP(nn.Module):
    """h -> ffn (column) -> activation -> ffn -> h (row). The gated forms
    (swiglu, geglu) use one fused ``[gate | up]`` projection and no
    biases; the others have biases."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        gated = cfg.activation in ("swiglu", "geglu")
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, (2 if gated else 1) * cfg.ffn_size,
            bias=not gated, params_dtype=cfg.params_dtype, device=device)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn_size, cfg.hidden_size, bias=not gated,
            params_dtype=cfg.params_dtype, device=device)

    def forward(self, hidden_states):
        cfg = self.config
        x = self.dense_h_to_4h(hidden_states.to(cfg.compute_dtype)).float()
        if cfg.activation in ("swiglu", "geglu"):
            gate, up = x.chunk(2, dim=-1)
            act = (F.silu(gate) if cfg.activation == "swiglu"
                   else F.gelu(gate, approximate="tanh"))
            x = act * up
        elif cfg.activation in ("relu", "relu2"):
            x = F.relu(x)
            if cfg.activation == "relu2":
                x = x * x
        else:
            x = F.gelu(x, approximate="tanh" if cfg.activation == "gelu"
                       else "none")
        return self.dense_4h_to_h(x.to(cfg.compute_dtype))


class ParallelTransformerLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x)). The
    norms read the residual stream as it is and write ``compute_dtype``
    (the JAX layer casts to fp32 before the norm and back after it: the
    same values, without the two cast passes)."""

    def __init__(self, config: TransformerConfig, layer_number: int = 0,
                 device=None):
        super().__init__()
        self.config = config
        self.input_layernorm = _make_norm(config, device)
        self.self_attention = ParallelAttention(config, layer_number, device)
        self.post_attention_layernorm = _make_norm(config, device)
        self.mlp = ParallelMLP(config, device)

    def forward(self, hidden_states, position_ids=None, cache=None,
                attention_mask=None):
        compute = self.config.compute_dtype
        attn_out = self.self_attention(
            self.input_layernorm(hidden_states, out_dtype=compute),
            position_ids, cache, attention_mask)
        hidden_states = hidden_states + attn_out.to(hidden_states.dtype)
        mlp_out = self.mlp(
            self.post_attention_layernorm(hidden_states, out_dtype=compute))
        return hidden_states + mlp_out.to(hidden_states.dtype)


class ParallelTransformer(nn.Module):
    """A stack of ``num_layers`` layers (sharing one KV cache when one is
    given)."""

    def __init__(self, config: TransformerConfig, num_layers=None,
                 device=None):
        super().__init__()
        n = num_layers if num_layers is not None else config.num_layers
        self.layers = nn.ModuleList(
            ParallelTransformerLayer(config, i, device) for i in range(n))

    def forward(self, hidden_states, position_ids=None, cache=None,
                attention_mask=None):
        for layer in self.layers:
            hidden_states = layer(hidden_states, position_ids, cache,
                                  attention_mask)
        return hidden_states
