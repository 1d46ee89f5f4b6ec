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

:func:`speculative_generate` is greedy speculative decoding over a
draft model, on the same :func:`verify_step` body the serving engine's
speculative round runs. :func:`beam_search` keeps ``num_beams`` beams a
row over a cache tiled per beam. :func:`prefill_prefix` prefills a shared
prompt prefix once, and ``generate(prefix_state=...)`` then prefills only
each request's suffix over a copy of it.

Tensor parallelism: a model built under a tp grid returns vocab-parallel
logits, and every sampling site here gathers them first
(:func:`_full_vocab`, JAX's), so each rank sees the same full logits
bit for bit and picks the same token. :func:`tensor_parallel_generate`
and :func:`tensor_parallel_beam_search` run :func:`generate`'s and
:func:`beam_search`'s loops on each rank's shard (every rank calls
them, sampling with an identically seeded generator);
:func:`init_params_tp` draws a tp = 1 model's weights and splits them
per rank. ``generate``, ``beam_search``, ``prefill_prefix`` and
``speculative_generate`` drive a tp = 1 model and refuse a tp grid.
"""

from typing import Optional

import torch

from apex_tpu_torch.models.kv_cache import KVCache, local_groups
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    gather_from_tensor_model_parallel_region,
)


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


def _full_vocab(logits):
    """Vocab-parallel logits gathered over the tp group (the logits
    themselves at tp = 1), so that sampling sees the whole vocabulary."""
    return gather_from_tensor_model_parallel_region(logits)


def _refuse_tp(message):
    if parallel_state.get_tensor_model_parallel_world_size() > 1:
        raise NotImplementedError(message)


def init_cache(model, batch_size: int) -> KVCache:
    """An empty KV cache for ``batch_size`` sequences of up to
    ``max_position_embeddings`` tokens, on the model's device (this
    rank's K/V groups under a tp grid)."""
    cfg = model.config
    return KVCache(model.num_layers, cfg.max_position_embeddings, batch_size,
                   local_groups(cfg), cfg.kv_channels, cfg.compute_dtype,
                   model.device)


@torch.no_grad()
def prefill(model, cache, tokens, positions, *, full_logits=False):
    """Run one prompt chunk through the KV cache. ``positions`` [b, s] (or
    [1, s]) are the tokens' absolute positions. Returns ``(cache, logits)``
    with the full-vocabulary logits at the last position [b, vocab], or
    at every position [b, s, vocab] with ``full_logits=True``."""
    logits = model(tokens, positions, cache)
    return cache, _full_vocab(logits if full_logits else logits[:, -1])


@torch.no_grad()
def decode_step(model, cache, tokens, positions):
    """One incremental forward over the KV cache (``tokens`` [b, s], s = 1
    in the decode loop). Returns ``(cache, logits)``, the full-vocabulary
    logits at the last position [b, vocab]."""
    logits = model(tokens, positions, cache)
    return cache, _full_vocab(logits[:, -1])


def _validate_decode(fn_name, model, prompt_tokens, max_new_tokens,
                     extra=0, extra_label="draft window"):
    """Shared validation of the decode entry points: the prompt, the new
    tokens and ``extra`` (the speculative window, or the shared prefix's
    length, named by ``extra_label``) must fit the position budget."""
    plen = prompt_tokens.shape[1]
    limit = model.config.max_position_embeddings
    if plen + max_new_tokens + extra > limit:
        extra_s = f" + {extra_label} ({extra})" if extra else ""
        raise ValueError(
            f"prompt ({plen}) + max_new_tokens ({max_new_tokens})"
            f"{extra_s} exceeds max_position_embeddings ({limit})")
    if max_new_tokens < 1:
        raise ValueError(f"{fn_name}() needs max_new_tokens >= 1")


@torch.no_grad()
def prefill_prefix(model, prefix_tokens):
    """Prefill a shared prompt prefix once: returns ``(cache, prefix_len)``
    for ``generate(prefix_state=...)``. Any number of ``generate`` calls
    may reuse it (each prefills its suffix into a copy), and a batch-1
    prefix broadcasts to any batch of suffixes."""
    _refuse_tp("prefill_prefix() drives a tp=1 model (at tp > 1 serve "
               "shared prefixes through ServeEngine(prefix_cache=True))")
    prefix_tokens = torch.as_tensor(prefix_tokens, device=model.device,
                                    dtype=torch.long)
    b, plen = prefix_tokens.shape
    limit = model.config.max_position_embeddings
    if plen >= limit:
        raise ValueError(f"prefix ({plen}) leaves no room under "
                         f"max_position_embeddings ({limit})")
    cache = init_cache(model, b)
    prefill(model, cache, prefix_tokens,
            torch.arange(plen, device=model.device)[None, :])
    return cache, plen


@torch.no_grad()
def generate(model, prompt_tokens, max_new_tokens: int, *, generator=None,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             prefix_state=None):
    """Prefill + token-by-token decode on the model's device. Returns
    [batch, prompt + max_new_tokens] int64 tokens; generated positions
    after an eos are ``pad_token_id``.

    Greedy when ``generator`` is None or ``temperature == 0``. Prompts
    must be unpadded (batch them by length). The last sampled token needs
    no forward, so ``max_new_tokens`` tokens take one prefill and
    ``max_new_tokens - 1`` decode steps.

    ``prefix_state`` (from :func:`prefill_prefix`): a shared prefilled
    prefix. ``prompt_tokens`` is then each request's suffix, prefilled at
    positions after the prefix into a copy of its cache, and the result
    is [batch, suffix + max_new_tokens]: token for token what a prefill
    of the concatenated prompt gives."""
    _refuse_tp("generate() drives a tp=1 model; use "
               "tensor_parallel_generate() (the same prefill and decode "
               "loop on each rank's shard)")
    return _generate("generate", model, prompt_tokens, max_new_tokens,
                     generator, temperature, top_k, top_p, eos_token_id,
                     pad_token_id, prefix_state)


def _generate(fn_name, model, prompt_tokens, max_new_tokens, generator,
              temperature, top_k, top_p, eos_token_id, pad_token_id,
              prefix_state=None):
    prompt_tokens = torch.as_tensor(prompt_tokens, device=model.device,
                                    dtype=torch.long)
    prefix_cache, prefix_len = None, 0
    if prefix_state is not None:
        prefix_cache, prefix_len = prefix_state
    _validate_decode(fn_name, model, prompt_tokens, max_new_tokens,
                     extra=prefix_len, extra_label="prefix")
    if generator is None:
        temperature = 0.0
    b, plen = prompt_tokens.shape
    # the suffix prefill writes in place: into a copy of the prefix (a
    # batch-1 prefix broadcast to b rows), which stays as it was
    cache = (init_cache(model, b) if prefix_cache is None
             else prefix_cache.broadcast_rows(b))
    positions = prefix_len + torch.arange(plen, device=model.device)[None, :]
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
            pos = torch.full((b, 1), prefix_len + plen + i,
                             device=model.device)
            cache, logits = decode_step(model, cache, nxt[:, None], pos)
    return torch.cat([prompt_tokens, torch.stack(out, dim=1)], dim=1)


def _top_k(x, k: int):
    """(values, indices) of the k largest entries of each row, ties
    broken toward the lower index, as ``lax.top_k`` does."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def beam_search(model, prompt_tokens, max_new_tokens: int,
                num_beams: int = 4, *, length_penalty: float = 1.0,
                eos_token_id: Optional[int] = None, pad_token_id: int = 0):
    """Beam-search decoding with a KV cache per beam. Returns ([batch,
    prompt + max_new_tokens] int64 tokens, [batch] fp32 scores): each
    row's best beam, its score the sum of its tokens' log-probabilities
    over ``length ** length_penalty`` (the length counts tokens up to and
    including an eos).

    The beams share the prompt's prefill; the cache is then repeated to
    batch * num_beams rows and reordered as each step reselects the
    beams (the top ``num_beams`` of the row's ``num_beams * vocab``
    candidates, fp32 log-softmax, ties to the lower index). A finished
    beam extends with ``pad_token_id`` at no cost."""
    _refuse_tp("beam_search() drives a tp=1 model; use "
               "tensor_parallel_beam_search()")
    return _beam_search("beam_search", model, prompt_tokens, max_new_tokens,
                        num_beams, length_penalty, eos_token_id,
                        pad_token_id)


def _beam_search(fn_name, model, prompt_tokens, max_new_tokens, num_beams,
                 length_penalty, eos_token_id, pad_token_id):
    prompt_tokens = torch.as_tensor(prompt_tokens, device=model.device,
                                    dtype=torch.long)
    _validate_decode(fn_name, model, prompt_tokens, max_new_tokens)
    k = int(num_beams)
    device = model.device
    b, plen = prompt_tokens.shape
    cache = init_cache(model, b)
    cache, logits = prefill(model, cache, prompt_tokens,
                            torch.arange(plen, device=device)[None, :])
    logp0 = torch.log_softmax(logits.float(), dim=-1)      # [b, v]
    vocab = logp0.shape[-1]
    cache = cache.repeat_rows(k)
    scores, tok0 = _top_k(logp0, k)                        # [b, k]
    done = (torch.zeros((b, k), dtype=torch.bool, device=device)
            if eos_token_id is None else tok0 == eos_token_id)
    lengths = torch.ones((b, k), dtype=torch.int32, device=device)
    seqs = torch.zeros((b * k, max_new_tokens), dtype=torch.long,
                       device=device)
    seqs[:, 0] = tok0.reshape(b * k)
    frozen = torch.full((vocab,), float("-inf"), device=device)
    frozen[pad_token_id] = 0.0
    rows = torch.arange(b, device=device)[:, None] * k
    for i in range(1, max_new_tokens):
        pos = torch.full((b * k, 1), plen + i - 1, device=device)
        cache, logits = decode_step(model, cache, seqs[:, i - 1:i], pos)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
        logp = torch.where(done[:, :, None], frozen, logp)
        total = scores[:, :, None] + logp                  # [b, k, v]
        scores, flat = _top_k(total.reshape(b, k * vocab), k)
        beam_idx = flat // vocab                           # [b, k]
        tok = flat % vocab
        gather = (rows + beam_idx).reshape(b * k)
        cache = cache.reorder(gather)
        done = done.gather(1, beam_idx)
        lengths = lengths.gather(1, beam_idx) + (~done).int()
        seqs = seqs.index_select(0, gather)
        seqs[:, i] = tok.reshape(b * k)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
    adjusted = scores / lengths.float() ** length_penalty
    best = torch.argmax(adjusted, dim=-1)                  # [b]
    best_seqs = seqs.index_select(0, rows[:, 0] + best)
    return (torch.cat([prompt_tokens, best_seqs], dim=1),
            adjusted.gather(1, best[:, None])[:, 0])


@torch.no_grad()
def verify_step(model, cache, chunk, positions):
    """One speculative-verification forward. ``chunk`` [b, k+1] is each
    row's last emitted token followed by the draft's k proposals, at
    absolute ``positions`` [b, k+1]; the target runs the whole window in
    one chunked forward over its KV cache (the window kernel, each row
    at its own offset). Returns ``(cache, v, logits)``: the greedy
    verdicts ``v`` [b, k+1] int64, ``v[:, i]`` the target's argmax for
    the position after ``chunk[:, i]``, and the logits [b, k+1, vocab]
    fp32."""
    logits = _full_vocab(model(chunk, positions, cache))
    return cache, torch.argmax(logits.float(), dim=-1), logits


@torch.no_grad()
def speculative_round(target_model, draft_model, tcache, dcache, last, n,
                      k: int):
    """One greedy speculative round, each row from its own level ``n``
    (int [b] tensor, the absolute position of ``last`` [b]): the draft
    takes ``k + 1`` decode steps through ``dcache`` (k proposals, then
    the completion feed of the last one, so that its cache has no hole
    after a full accept), and the target verifies ``[last, d_1..d_k]``
    in one chunked forward through ``tcache`` (:func:`verify_step`).
    Returns ``(d [b, k], v [b, k+1], logits [b, k+1, vocab], accepted
    [b])``, ``accepted[i]`` the length of row i's matching prefix. The
    caller applies its acceptance rule, emits, and rolls both caches
    back."""
    n = n.long()
    tok, proposals = last, []
    for i in range(k + 1):
        _, lg = decode_step(draft_model, dcache, tok[:, None],
                            (n + i)[:, None])
        tok = torch.argmax(lg.float(), dim=-1)
        proposals.append(tok)
    d = torch.stack(proposals[:k], dim=1)  # [b, k]; the last: the feed
    chunk = torch.cat([last[:, None], d], dim=1)
    steps = torch.arange(k + 1, device=n.device)
    _, v, logits = verify_step(target_model, tcache, chunk,
                               n[:, None] + steps)
    accepted = torch.cumprod((d == v[:, :k]).long(), dim=1).sum(dim=1)
    return d, v, logits, accepted


def _set_cache_index(cache, value):
    """Roll every row's fill level to ``value`` (a host int or a [b]
    tensor): rows beyond it stay resident but masked, since the decode
    attention masks by absolute position, so a rollback is just the
    level. Returns the cache."""
    cache.set_lengths(value)
    return cache


@torch.no_grad()
def speculative_generate(target_model, draft_model, prompt_tokens,
                         max_new_tokens: int, *, num_draft_tokens: int = 4,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0):
    """Greedy speculative decoding: rounds of
    :func:`speculative_round` (``num_draft_tokens`` draft proposals
    verified in one chunked target forward), each emitting the longest
    matching prefix plus
    one target token (the correction, or a bonus on full accept) is
    emitted. Token-exact against ``generate(target_model, ...)`` greedy:
    every token is a target argmax over the same prefix. The rows of the
    batch accept the round's minimum across the batch (still exact per
    row). Both caches roll back by their fill levels. Returns [batch,
    prompt + max_new_tokens] int64, positions after an eos set to
    ``pad_token_id``. Both models hold their weights on one device and
    share a vocabulary."""
    _refuse_tp("speculative_generate() drives tp=1 models")
    k = int(num_draft_tokens)
    if k < 1:
        raise ValueError(f"num_draft_tokens ({num_draft_tokens}) must be "
                         f">= 1")
    if target_model.config.vocab_size != draft_model.config.vocab_size:
        raise ValueError(
            f"target vocab ({target_model.config.vocab_size}) != draft vocab "
            f"({draft_model.config.vocab_size}): the models must share a "
            f"tokenizer")
    device = target_model.device
    prompt_tokens = torch.as_tensor(prompt_tokens, device=device,
                                    dtype=torch.long)
    for m in (target_model, draft_model):
        # the draft window overshoots the emitted tokens by up to k
        _validate_decode("speculative_generate", m, prompt_tokens,
                         max_new_tokens, extra=k)
    b, plen = prompt_tokens.shape
    tcache = init_cache(target_model, b)
    dcache = init_cache(draft_model, b)
    pos = torch.arange(plen, device=device)[None, :]
    tcache, logits = prefill(target_model, tcache, prompt_tokens, pos)
    prefill(draft_model, dcache, prompt_tokens, pos)
    last = torch.argmax(logits.float(), dim=-1)
    out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long,
                     device=device)
    out[:, 0] = last
    n = 1
    while n < max_new_tokens:
        t0 = plen + n - 1  # absolute position of `last`
        d, v, _, accepted = speculative_round(
            target_model, draft_model, tcache, dcache, last,
            torch.full((b,), t0, device=device), k)
        a = int(accepted.min())
        last = v[:, a]
        emit = torch.cat([d[:, :a], last[:, None]], dim=1)
        width = min(a + 1, max_new_tokens - n)
        out[:, n:n + width] = emit[:, :width]
        n += a + 1
        # both caches hold exactly the positions before the new `last`
        _set_cache_index(tcache, plen + n - 1)
        _set_cache_index(dcache, plen + n - 1)
    if eos_token_id is not None:
        is_eos = (out == eos_token_id).long()
        after = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
        out = out.masked_fill(after, pad_token_id)
    return torch.cat([prompt_tokens, out], dim=1)


def _load_rank(model, stacked_params):
    """Load this rank's slice of ``stacked_params`` into ``model`` (None:
    the model already holds its shard)."""
    if stacked_params is not None:
        from apex_tpu_torch.models.params import rank_state_dict
        model.load_state_dict(rank_state_dict(
            stacked_params, parallel_state.get_tensor_model_parallel_rank()))


@torch.no_grad()
def init_params_tp(model, seed: int):
    """The stacked ``[tp, ...]`` ``state_dict`` for ``model`` (a
    ``GPTModel`` or dense ``DeepseekModel`` built under the tp grid,
    ``tp`` ranks): the weights of its tp = 1 twin drawn from ``seed`` on
    the CPU (:func:`~apex_tpu_torch.models.params.init_weights`), split
    per rank by :func:`~apex_tpu_torch.models.tp_split.split_params_for_tp`
    or ``split_mla_params_for_tp``. Rank r's shard is index r: a tp = m
    model loaded from it holds the weights a tp = 1 model drawn on the
    CPU from the same seed holds. Built on the host, so every rank may
    call it and move only its own shard to the card
    (:func:`tensor_parallel_generate`)."""
    from apex_tpu_torch.models import tp_split
    from apex_tpu_torch.models.gpt import GPTModel
    from apex_tpu_torch.models.mla import DeepseekModel
    from apex_tpu_torch.models.params import init_weights

    cfg = model.config
    tp = parallel_state.get_tensor_model_parallel_world_size()
    with parallel_state.unsharded():
        if isinstance(model, DeepseekModel):
            twin = DeepseekModel(cfg, device="cpu")
            split = tp_split.split_mla_params_for_tp
        elif isinstance(model, GPTModel):
            twin = GPTModel(cfg, model.num_layers, device="cpu")
            split = tp_split.split_params_for_tp
        else:
            raise TypeError(f"init_params_tp: {type(model).__name__} is "
                            f"not a GPTModel or DeepseekModel")
    init_weights(twin, seed)
    return split(cfg, twin.state_dict(), tp)


@torch.no_grad()
def tensor_parallel_generate(model, stacked_params, prompt_tokens,
                             max_new_tokens: int, *, generator=None,
                             temperature: float = 1.0,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             eos_token_id: Optional[int] = None,
                             pad_token_id: int = 0):
    """:func:`generate`'s prefill and decode loop on this rank's shard,
    every rank of the tp grid calling it with the same prompts: this
    rank's slice of ``stacked_params`` (:func:`init_params_tp`, or
    ``split_params_for_tp``; None when ``model`` already holds its
    shard) is loaded into ``model``, each step's vocab-parallel logits
    are gathered, and every rank samples the same token from the same
    full logits (greedy, or with ``generator`` seeded alike on every
    rank). Returns [batch, prompt + max_new_tokens] int64."""
    _load_rank(model, stacked_params)
    return _generate("tensor_parallel_generate", model, prompt_tokens,
                     max_new_tokens, generator, temperature, top_k, top_p,
                     eos_token_id, pad_token_id)


@torch.no_grad()
def tensor_parallel_beam_search(model, stacked_params, prompt_tokens,
                                max_new_tokens: int, num_beams: int = 4, *,
                                length_penalty: float = 1.0,
                                eos_token_id: Optional[int] = None,
                                pad_token_id: int = 0):
    """:func:`beam_search` on this rank's shard (``stacked_params`` as
    :func:`tensor_parallel_generate` takes it). Every rank computes the
    same log-probabilities from the gathered logits, so each reorders its
    own cache (this rank's groups, the beams along the batch axis) the
    same way. Returns (tokens, scores) as :func:`beam_search`."""
    _load_rank(model, stacked_params)
    return _beam_search("tensor_parallel_beam_search", model, prompt_tokens,
                        max_new_tokens, num_beams, length_penalty,
                        eos_token_id, pad_token_id)
