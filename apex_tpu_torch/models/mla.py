"""Multi-head Latent Attention (DeepSeek-V2) language model.

Counterpart of ``apex_tpu/models/mla.py``: K/V are projected through a
small shared latent (``kv_lora_rank`` wide, plus a decoupled rope
sub-vector shared by every head) and re-expanded per head; queries go
through their own latent when ``q_lora_rank`` is set. Per head, queries
and keys carry ``qk_nope_head_dim`` positionless and ``qk_rope_head_dim``
rotary channels (interleaved pairs), values ``v_head_dim``; scores are
scaled by (nope + rope)**-0.5. RMSNorm everywhere (the RMSNorm kernel,
on fp32 inputs as in JAX), SwiGLU MLPs, an untied fp32 head. From
``first_k_dense_replace`` on, a config with ``n_routed_experts`` routes
each token to ``moe_top_k`` small experts
(:class:`apex_tpu_torch.transformer.moe.SwitchMLP`) plus an always-on
shared expert.

Three modes, as JAX's ``mode``:

- ``"train"``: full causal attention over the chunk (-1e9 above the
  diagonal, fp32 softmax), the kv_b expansion explicit.
- ``"prefill"`` and ``"step"``: the absorbed-projection decode over a
  latent cache (:class:`MLACache`) that holds, per layer, only
  ``[max_decode_length, b, kv_lora_rank + qk_rope_head_dim]`` rows of
  [normed latent | rotated k_pe]. ``kv_b``'s weight (one parameter,
  shared with the train mode's linear) splits into W_nope, which folds
  the queries into latent space, and W_v, which expands the attended
  latent. A single-token step over a cache that a tile divides
  (:func:`apex_tpu_torch.contrib.mla_decode.use_flash`) goes through
  :func:`~apex_tpu_torch.contrib.mla_decode.mla_flash_decode` (the MLA
  decode kernel on the card); every other case through fp32 einsums.

Dtypes follow JAX: parameters in ``params_dtype``, activations and the
cache in ``compute_dtype``, norm statistics, RoPE, scores, softmax and
the SwiGLU activation in fp32, products of ``compute_dtype`` operands
summed in fp32 where JAX asks ``preferred_element_type=float32``.

Tensor parallelism as JAX's for dense configurations: each rank of a tp
grid holds ``num_heads / tp`` heads of ``q_b`` and ``kv_b`` (columns)
and of ``o`` (rows), its halves of each SwiGLU, and its vocabulary
columns of the head, so the logits are vocab-parallel and the generate
loops gather them; the latent projections, their norms and the latent
cache replicate. A routed mixture-of-experts layer refuses tp > 1
(expert parallelism, ROADMAP queue A item 6).
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.contrib import mla_decode
from apex_tpu_torch.models.generation import _full_vocab
from apex_tpu_torch.models.transformer_lm import _rope_core
from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.transformer.moe import SwitchMLP
from apex_tpu_torch.transformer.parallel_state import (
    get_tensor_model_parallel_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    copy_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The fields of ``apex_tpu.models.mla.MLAConfig`` with torch dtypes
    and JAX's defaults. The einsum MoE dispatch, which no ported path
    runs, is refused (ROADMAP queue A item 6)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 12
    num_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    ffn_hidden_size: int = 8192
    rms_eps: float = 1e-6
    rotary_base: float = 10000.0
    max_decode_length: int = 512
    n_routed_experts: Optional[int] = None
    moe_intermediate_size: Optional[int] = None
    n_shared_experts: Optional[int] = None
    moe_top_k: int = 2
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    first_k_dense_replace: int = 0
    moe_capacity_factor: Optional[float] = None
    moe_dispatch_mode: str = "auto"
    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.moe_dispatch_mode == "einsum":
            raise NotImplementedError(
                "moe_dispatch_mode 'einsum' is not ported yet: ROADMAP "
                "queue A item 6 (expert parallelism and the rest of MoE)")
        if self.moe_dispatch_mode not in ("auto", "scatter", "ragged"):
            raise ValueError(
                f"unknown moe_dispatch_mode {self.moe_dispatch_mode!r}")

    @property
    def qk_head_dim(self):
        return self.qk_nope_head_dim + self.qk_rope_head_dim


class MLACache:
    """The latent cache of a :class:`DeepseekModel` (counterpart of flax's
    ``cache`` collection in decode mode): per layer a buffer
    ``[max_len, b, kv_lora_rank + qk_rope_head_dim]`` in
    ``compute_dtype``, written in place, and ``pos``, the host's count of
    filled positions (every row of the batch at the same level, as JAX's
    scalar counter)."""

    def __init__(self, config: MLAConfig, batch: int, device):
        shape = (config.max_decode_length, batch,
                 config.kv_lora_rank + config.qk_rope_head_dim)
        self.latent = [torch.zeros(shape, dtype=config.compute_dtype,
                                   device=device)
                       for _ in range(config.num_layers)]
        self.pos = 0


class _Dense(nn.Module):
    """flax ``nn.Dense(dtype=compute_dtype)`` without a bias: ``kernel``
    [in, out] in ``params_dtype``; input and kernel cast to
    ``compute_dtype``, the product in that dtype."""

    def __init__(self, in_features, out_features, config, device):
        super().__init__()
        self.compute_dtype = config.compute_dtype
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=config.params_dtype,
            device=device))

    def forward(self, x):
        cd = self.compute_dtype
        return torch.matmul(x.to(cd), self.kernel.to(cd))


def _norm(config, width, device):
    return FusedRMSNorm(width, eps=config.rms_eps, device=device)


class MLAAttention(nn.Module):
    """Latent-compressed attention: [s, b, h] -> [s, b, h] (module doc)."""

    def __init__(self, config: MLAConfig, layer_idx: int = 0, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.layer_idx = layer_idx
        self.n_local = divide(cfg.num_heads,
                              get_tensor_model_parallel_world_size())
        n, lat, rope = (cfg.num_heads, cfg.kv_lora_rank,
                        cfg.qk_rope_head_dim)
        pd = cfg.params_dtype
        if cfg.q_lora_rank:
            self.q_a = _Dense(cfg.hidden_size, cfg.q_lora_rank, cfg, device)
            self.q_a_norm = _norm(cfg, cfg.q_lora_rank, device)
            q_in = cfg.q_lora_rank
        else:
            q_in = cfg.hidden_size
        self.q_b = ColumnParallelLinear(q_in, n * cfg.qk_head_dim, bias=False,
                                        gather_output=False,
                                        params_dtype=pd, device=device)
        self.kv_a = _Dense(cfg.hidden_size, lat + rope, cfg, device)
        self.kv_a_norm = _norm(cfg, lat, device)
        self.kv_b = ColumnParallelLinear(
            lat, n * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False,
            gather_output=False, params_dtype=pd, device=device)
        self.o = RowParallelLinear(n * cfg.v_head_dim, cfg.hidden_size,
                                   bias=False, input_is_parallel=True,
                                   params_dtype=pd, device=device)

    def forward(self, x, position_ids=None, mode="train", cache=None):
        cfg = self.config
        cd = cfg.compute_dtype
        n, nope, rope = (self.n_local, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim)
        lat, vd = cfg.kv_lora_rank, cfg.v_head_dim
        s, b, _ = x.shape
        x = x.to(cd)
        if cfg.q_lora_rank:
            qa = self.q_a_norm(self.q_a(x).float(), out_dtype=cd)
            q = self.q_b(qa)
        else:
            q = self.q_b(x)
        q = q.reshape(s, b, n, cfg.qk_head_dim)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        ckv = self.kv_a(x)
        compressed = self.kv_a_norm(ckv[..., :lat].float().contiguous(),
                                    out_dtype=cd)
        if mode != "train":
            return self._decode_tail(ckv, compressed, q_nope, q_pe, mode,
                                     cache)

        kv = self.kv_b(compressed).reshape(s, b, n, nope + vd)
        k_nope, value = kv[..., :nope], kv[..., nope:]
        q_pe = _rope_core(q_pe, cfg.rotary_base, position_ids, rope,
                          interleaved=True)
        k_pe = _rope_core(ckv[..., None, lat:], cfg.rotary_base,
                          position_ids, rope, interleaved=True)
        k_pe = k_pe.expand(s, b, n, rope)
        qc = torch.cat([q_nope, q_pe], -1).to(cd)
        kc = torch.cat([k_nope, k_pe], -1).to(cd)
        scores = torch.einsum("qbnd,kbnd->bnqk", qc.float(), kc.float())
        scores = scores * float(cfg.qk_head_dim ** -0.5)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(causal, -1e9)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bnqk,kbnd->qbnd", probs.to(cd).float(),
                           value.to(cd).float())
        return self.o(ctx.reshape(s, b, n * vd).to(cd))

    def _decode_tail(self, ckv, compressed, q_nope, q_pe, mode, cache):
        """The absorbed-projection decode (JAX's ``_decode_tail``): write
        this chunk's latent rows at ``cache.pos`` (0 for a prefill;
        clamped as ``dynamic_update_slice``), fold the queries into
        latent space, attend over the cache, expand through W_v."""
        cfg = self.config
        cd = cfg.compute_dtype
        n, nope, rope = (self.n_local, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim)
        lat, vd = cfg.kv_lora_rank, cfg.v_head_dim
        s, b = ckv.shape[:2]
        w_full = self.kv_b.weight.to(cd).reshape(lat, n, nope + vd)
        w_nope, w_v = w_full[..., :nope], w_full[..., nope:]

        pos = 0 if mode == "prefill" else cache.pos
        positions = pos + torch.arange(s, device=ckv.device)
        q_pe = _rope_core(q_pe, cfg.rotary_base, positions, rope,
                          interleaved=True)
        k_pe = _rope_core(ckv[..., None, lat:], cfg.rotary_base, positions,
                          rope, interleaved=True)[:, :, 0]

        buf = cache.latent[self.layer_idx]
        max_len = buf.shape[0]
        start = max(0, min(pos, max_len - s))
        buf[start:start + s] = torch.cat([compressed, k_pe], -1).to(cd)

        q_lat = torch.einsum("sbnd,lnd->sbnl", q_nope.to(cd).float(),
                             w_nope.float()).to(cd)
        scale = float(cfg.qk_head_dim ** -0.5)
        if mode == "step" and s == 1 and mla_decode.use_flash(max_len):
            q_full = torch.cat([q_lat[0], q_pe[0].to(cd)], -1)
            ctx_lat = mla_decode.mla_flash_decode(
                q_full, buf, pos + 1, lat, scale)[None].to(cd)
        else:
            ctx_lat = self._einsum_attention(q_lat, q_pe.to(cd), buf, pos,
                                             scale)
        ctx = torch.einsum("sbnl,lnd->sbnd", ctx_lat.float(), w_v.float())
        return self.o(ctx.reshape(s, b, n * vd).to(cd))

    def _einsum_attention(self, q_lat, q_pe, buf, pos, scale):
        """The decode attention of every case but the kernel's (JAX's
        einsum branch): fp32 scores of the latent and rope parts over the
        whole buffer, -1e9 past each query's position, fp32 softmax, the
        latent rows weighted in fp32 -> ctx_lat [s, b, n, lat] in
        ``compute_dtype``. In place where JAX's arithmetic allows, since
        a long prefill's scores are [b, n, s, max_len] fp32."""
        cd = self.config.compute_dtype
        lat = self.config.kv_lora_rank
        s = q_lat.shape[0]
        c_lat, c_pe = buf[..., :lat].float(), buf[..., lat:].float()
        scores = torch.einsum("sbnl,tbl->bnst", q_lat.float(), c_lat)
        scores += torch.einsum("sbnd,tbd->bnst", q_pe.float(), c_pe)
        scores *= scale
        jpos = torch.arange(buf.shape[0], device=buf.device)[None, :]
        ipos = pos + torch.arange(s, device=buf.device)[:, None]
        scores.masked_fill_(jpos > ipos, -1e9)
        probs = torch.softmax(scores, dim=-1).to(cd)
        del scores
        return torch.einsum("bnst,tbl->sbnl", probs.float(), c_lat).to(cd)


class _SwiGLU(nn.Module):
    """gate_up (column) -> silu(gate) * up in fp32 -> down (row)."""

    def __init__(self, config: MLAConfig, ffn: Optional[int] = None,
                 device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        ffn = ffn or cfg.ffn_hidden_size
        self.gate_up = ColumnParallelLinear(
            cfg.hidden_size, 2 * ffn, bias=False, gather_output=False,
            params_dtype=cfg.params_dtype, device=device)
        self.down = RowParallelLinear(ffn, cfg.hidden_size, bias=False,
                                      input_is_parallel=True,
                                      params_dtype=cfg.params_dtype,
                                      device=device)

    def forward(self, x):
        cd = self.config.compute_dtype
        gate, up = self.gate_up(x.to(cd)).float().chunk(2, dim=-1)
        return self.down((F.silu(gate) * up).to(cd))


class DeepseekBlock(nn.Module):
    """Pre-norm block: h + attn(norm(h)), then h + mlp(norm(h)); the MLP
    is a SwiGLU, or from ``first_k_dense_replace`` on (with
    ``n_routed_experts``) routed experts scaled by
    ``routed_scaling_factor`` plus the shared expert."""

    def __init__(self, config: MLAConfig, layer_idx: int = 0, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.input_norm = _norm(cfg, cfg.hidden_size, device)
        self.self_attn = MLAAttention(cfg, layer_idx, device)
        self.post_attn_norm = _norm(cfg, cfg.hidden_size, device)
        self.is_moe = (cfg.n_routed_experts is not None
                       and layer_idx >= cfg.first_k_dense_replace)
        self.shared_mlp = None
        if not self.is_moe:
            self.mlp = _SwiGLU(cfg, device=device)
            return
        E, k = cfg.n_routed_experts, cfg.moe_top_k
        self.mlp = SwitchMLP(
            cfg.hidden_size, cfg.moe_intermediate_size, E, top_k=k,
            # default: dropless (E/k), the HF-parity semantics
            capacity_factor=(cfg.moe_capacity_factor
                             if cfg.moe_capacity_factor is not None
                             else float(E) / k),
            normalize_topk=cfg.norm_topk_prob, activation="swiglu",
            params_dtype=cfg.params_dtype, compute_dtype=cfg.compute_dtype,
            dispatch_mode=cfg.moe_dispatch_mode, device=device)
        if cfg.n_shared_experts:
            self.shared_mlp = _SwiGLU(
                cfg, cfg.n_shared_experts * cfg.moe_intermediate_size,
                device)

    def forward(self, h, position_ids=None, mode="train", cache=None):
        cfg = self.config
        cd = cfg.compute_dtype
        x = self.input_norm(h.float(), out_dtype=cd)
        h = h + self.self_attn(x, position_ids, mode, cache).to(h.dtype)
        x = self.post_attn_norm(h.float(), out_dtype=cd)
        if not self.is_moe:
            return h + self.mlp(x).to(h.dtype)
        routed = self.mlp(x)
        out = routed * torch.tensor(cfg.routed_scaling_factor,
                                    dtype=routed.dtype)
        if self.shared_mlp is not None:
            out = out + self.shared_mlp(x)
        return h + out.to(h.dtype)


class DeepseekModel(nn.Module):
    """DeepSeek-V2-style causal LM on MLA: tokens [b, s] -> logits [b, s,
    vocab / tp] fp32. ``forward(tokens)`` is the training forward (positions
    0..s-1 unless given); :meth:`decode_prefill` and :meth:`decode_step`
    run the latent-cache decode and return ``(logits, cache)``."""

    def __init__(self, config: MLAConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, cfg.params_dtype, device)
        self.layers = nn.ModuleList(
            DeepseekBlock(cfg, i, device) for i in range(cfg.num_layers))
        self.final_norm = _norm(cfg, cfg.hidden_size, device)
        self.lm_head = nn.Parameter(torch.empty(
            cfg.hidden_size,
            divide(cfg.vocab_size, get_tensor_model_parallel_world_size()),
            dtype=cfg.params_dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    def init_cache(self, batch: int) -> MLACache:
        return MLACache(self.config, batch, self.device)

    def forward(self, tokens, position_ids=None, mode="train", cache=None):
        cfg = self.config
        cd = cfg.compute_dtype
        h = self.embed_tokens(tokens).to(cd).transpose(0, 1).contiguous()
        pos = position_ids.transpose(0, 1) if position_ids is not None \
            else None
        for layer in self.layers:
            h = layer(h, pos, mode, cache)
        h = copy_to_tensor_model_parallel_region(
            self.final_norm(h.float(), out_dtype=cd))
        # compute_dtype operands, fp32 products and sums, as JAX's head
        logits = torch.matmul(h.float(), self.lm_head.to(cd).float())
        return logits.transpose(0, 1)

    @torch.no_grad()
    def decode_prefill(self, tokens, cache: Optional[MLACache] = None):
        """Latent-cache decode, phase 1: the prompt [b, s] at positions
        0..s-1 into ``cache`` (a new one when None). Returns (logits,
        cache)."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0])
        logits = self(tokens, mode="prefill", cache=cache)
        cache.pos = tokens.shape[1]
        return logits, cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: MLACache):
        """Latent-cache decode, phase 2: ``tokens`` [b, s] (one token for
        the hot loop) at positions ``cache.pos`` onward. Returns (logits,
        cache)."""
        logits = self(tokens, mode="step", cache=cache)
        cache.pos += tokens.shape[1]
        return logits, cache


@torch.no_grad()
def mla_greedy_generate(model, prompt_tokens, max_new_tokens):
    """Greedy decode by re-running the training forward over the whole
    sequence for each token (the oracle path)."""
    toks = torch.as_tensor(prompt_tokens, device=model.device)
    for _ in range(max_new_tokens):
        nxt = torch.argmax(_full_vocab(model(toks)[:, -1]), dim=-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return toks


@torch.no_grad()
def mla_cached_generate(model, prompt_tokens, max_new_tokens):
    """Greedy decode on the latent cache: one prefill, then one
    single-token :meth:`DeepseekModel.decode_step` per further token.
    Token-exact against :func:`mla_greedy_generate`."""
    cfg = model.config
    plen = prompt_tokens.shape[1]
    if plen + max_new_tokens > cfg.max_decode_length:
        raise ValueError(
            f"prompt + max_new_tokens ({plen + max_new_tokens}) exceeds "
            f"max_decode_length ({cfg.max_decode_length})")
    toks = torch.as_tensor(prompt_tokens, device=model.device)
    if max_new_tokens == 0:
        return toks
    logits, cache = model.decode_prefill(toks)
    out = [torch.argmax(_full_vocab(logits[:, -1]), dim=-1)]
    for _ in range(max_new_tokens - 1):
        logits, cache = model.decode_step(out[-1][:, None], cache)
        out.append(torch.argmax(_full_vocab(logits[:, -1]), dim=-1))
    return torch.cat([toks, torch.stack(out, dim=1)], dim=1)
