"""Autoregressive generation with KV-cache decoding.

Counterpart of ``apex_tpu/models/generation.py``: :func:`prefill` runs
the prompt through the cache in one chunk, :func:`decode_step` runs one
token, and :func:`generate` is the loop over them. PyTorch runs eagerly,
so where the JAX package jits a prefill and scans the decode steps this
is a Python loop; the cache is updated in place. Sampling draws from a
``torch.Generator``, so its draws differ from ``jax.random``'s; greedy
decoding and the filtered logits (:func:`filter_logits`) are the same.

    model = GPTModel(cfg)                      # on the card
    out = generate(model, prompt_tokens, max_new_tokens=64)

Beam search, shared prefixes, speculative decoding and tensor
parallelism come in later slices.
"""

from typing import Optional

import torch

from apex_tpu_torch.models.kv_cache import KVCache


def filter_logits(logits, temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """fp32 logits / temperature with top-k, then top-p (nucleus)
    filtering: filtered-out entries become -inf. top-k keeps the k highest
    (clamped to the vocab); top-p keeps the smallest prefix of the sorted
    distribution whose mass reaches p (the top token always stays)."""
    logits = logits.float() / temperature
    if top_k is not None:
        k = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k]
        logits = logits.masked_fill(logits < kth[:, None], float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        threshold = torch.where(keep, sorted_logits,
                                torch.full_like(sorted_logits, float("inf"))
                                ).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def sample_logits(logits, generator=None, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None):
    """Token ids [batch] from [batch, vocab] logits. ``temperature=0`` is
    greedy argmax (the first of equal maxima); otherwise a draw from the
    :func:`filter_logits` distribution with ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def init_cache(model, batch_size: int) -> KVCache:
    """An empty KV cache for ``batch_size`` sequences of up to
    ``max_position_embeddings`` tokens, on the model's device."""
    cfg = model.config
    return KVCache(model.num_layers, cfg.max_position_embeddings, batch_size,
                   cfg.query_groups, cfg.kv_channels, cfg.compute_dtype,
                   model.device)


@torch.no_grad()
def prefill(model, cache, tokens, positions, *, full_logits=False):
    """Run one prompt chunk through the KV cache. ``positions`` [b, s] (or
    [1, s]) are the tokens' absolute positions. Returns ``(cache, logits)``
    with the logits at the last position [b, vocab], or at every position
    [b, s, vocab] with ``full_logits=True``."""
    logits = model(tokens, positions, cache)
    return cache, (logits if full_logits else logits[:, -1])


@torch.no_grad()
def decode_step(model, cache, tokens, positions):
    """One incremental forward over the KV cache (``tokens`` [b, s], s = 1
    in the decode loop). Returns ``(cache, logits)`` at the last position
    [b, vocab]."""
    logits = model(tokens, positions, cache)
    return cache, logits[:, -1]


def _validate_decode(fn_name, model, prompt_tokens, max_new_tokens):
    plen = prompt_tokens.shape[1]
    limit = model.config.max_position_embeddings
    if plen + max_new_tokens > limit:
        raise ValueError(
            f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_position_embeddings ({limit})")
    if max_new_tokens < 1:
        raise ValueError(f"{fn_name}() needs max_new_tokens >= 1")


@torch.no_grad()
def generate(model, prompt_tokens, max_new_tokens: int, *, generator=None,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0):
    """Prefill + token-by-token decode on the model's device. Returns
    [batch, prompt + max_new_tokens] int64 tokens; generated positions
    after an eos are ``pad_token_id``.

    Greedy when ``generator`` is None or ``temperature == 0``. Prompts
    must be unpadded (batch them by length). The last sampled token needs
    no forward, so ``max_new_tokens`` tokens take one prefill and
    ``max_new_tokens - 1`` decode steps."""
    prompt_tokens = torch.as_tensor(prompt_tokens, device=model.device,
                                    dtype=torch.long)
    _validate_decode("generate", model, prompt_tokens, max_new_tokens)
    if generator is None:
        temperature = 0.0
    b, plen = prompt_tokens.shape
    cache = init_cache(model, b)
    positions = torch.arange(plen, device=model.device)[None, :]
    cache, logits = prefill(model, cache, prompt_tokens, positions)
    done = torch.zeros(b, dtype=torch.bool, device=model.device)
    out = []
    for i in range(max_new_tokens):
        nxt = sample_logits(logits, generator, temperature, top_k, top_p)
        nxt = torch.where(done, pad_token_id, nxt)
        if eos_token_id is not None:
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        if i + 1 < max_new_tokens:
            pos = torch.full((b, 1), plen + i, device=model.device)
            cache, logits = decode_step(model, cache, nxt[:, None], pos)
    return torch.cat([prompt_tokens, torch.stack(out, dim=1)], dim=1)
