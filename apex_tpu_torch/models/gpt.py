"""GPT language model over the transformer stack, and its loss.

Counterpart of ``apex_tpu.models.GPTModel`` and ``gpt_loss_fn``: token
embedding (plus learned ``position_embeddings`` [max_positions, hidden]
where the model has them, added in ``params_dtype`` before the cast to
``compute_dtype``), the layer stack over the Megatron [s, b, h] layout,
the final norm and the LM head (untied ``lm_head`` [hidden, vocab], or
the embedding table when tied), logits in fp32. Under a tp grid of ``tp``
ranks the logits are vocab-parallel, this rank's ``vocab / tp`` columns
(the head's local columns, or the tied table's local rows), as JAX's;
:func:`~apex_tpu_torch.models.generation.prefill` and the other sampling
sites gather them. With a KV cache the model runs as JAX's
``decode=True`` model; without one it runs the training forward, and a
step is

    loss = gpt_loss_fn(model(tokens), labels)
    loss.backward(); opt.step(); opt.zero_grad()
"""

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.transformer_lm import (
    ParallelTransformer,
    TransformerConfig,
    _make_norm,
)
from apex_tpu_torch.transformer.parallel_state import (
    get_tensor_model_parallel_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    copy_to_tensor_model_parallel_region,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import divide


class GPTModel(nn.Module):
    """Causal LM: tokens [b, s] and their absolute positions [b, s] (or
    [1, s]) -> logits [b, s, vocab / tp] in fp32. With ``cache`` the chunk's
    K/V are appended to it at each row's own fill level (updated in
    place, every level advanced by s) and positions default to each
    row's level onward (JAX's learned-position model defaults to 0..s-1
    there; the two agree on the prefill chunk);
    without one the training forward runs (positions default to 0..s-1),
    differentiable in every parameter. ``attention_mask`` (True =
    masked, broadcast to [b, heads, s, s]) takes the training forward's
    masked softmax path."""

    def __init__(self, config: TransformerConfig, num_layers=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.num_layers = (num_layers if num_layers is not None
                           else cfg.num_layers)
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, cfg.params_dtype, device)
        self.position_embeddings = (nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size,
            dtype=cfg.params_dtype, device=device))
            if cfg.position_embedding_type == "learned" else None)
        self.transformer = ParallelTransformer(cfg, self.num_layers, device)
        self.final_layernorm = _make_norm(cfg, device)
        vocab = divide(cfg.vocab_size, get_tensor_model_parallel_world_size())
        self.lm_head = (None if cfg.tie_word_embeddings else nn.Parameter(
            torch.empty(cfg.hidden_size, vocab, dtype=cfg.params_dtype,
                        device=device)))

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.weight.device

    def forward(self, tokens, position_ids=None, cache=None,
                attention_mask=None):
        cfg = self.config
        s = tokens.shape[1]
        if cache is not None:
            cache.chunk(s)
        h = self.word_embeddings(tokens)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = (cache.positions.t() if cache is not None
                                else torch.arange(s, device=tokens.device
                                                  )[None, :])
            # clamped as JAX's gather clamps: a free serving slot that
            # pads a bucket advances its level past the table
            h = h + self.position_embeddings[position_ids.clamp(
                max=cfg.max_position_embeddings - 1)]
        h = h.to(cfg.compute_dtype).transpose(0, 1).contiguous()  # [s, b, h]
        positions = (None if position_ids is None
                     else position_ids.transpose(0, 1))  # [s, b] or [s, 1]
        h = self.transformer(h, positions, cache, attention_mask)
        if cache is not None:
            cache.advance(s)
        h = copy_to_tensor_model_parallel_region(
            self.final_layernorm(h, out_dtype=cfg.compute_dtype))
        if cfg.tie_word_embeddings:
            logits = self.word_embeddings.attend(h)
        else:
            # bf16 x bf16 products accumulated in fp32, as the JAX head's
            # einsum with preferred_element_type=float32
            head = self.lm_head.to(cfg.compute_dtype).float()
            logits = torch.matmul(h.float(), head)
        return logits.transpose(0, 1)  # [b, s, vocab / tp]


def gpt_loss_fn(logits, labels, loss_mask=None):
    """Mean per-token cross entropy of logits [b, s, vocab] against labels
    [b, s]; with ``loss_mask`` [b, s], the masked mean (at least one
    token in the denominator)."""
    losses = vocab_parallel_cross_entropy(logits, labels)
    if loss_mask is not None:
        loss_mask = loss_mask.float()
        return torch.sum(losses * loss_mask) / torch.clamp(
            torch.sum(loss_mask), min=1.0)
    return torch.mean(losses)
