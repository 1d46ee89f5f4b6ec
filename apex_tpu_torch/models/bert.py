"""BERT over the transformer stack, and its pretraining loss.

Counterpart of ``apex_tpu.models.BertModel`` and ``bert_loss_fn``, with
its parameter names, layouts and dtypes: word, learned position and
token-type embeddings (added in ``params_dtype``, then cast to
``compute_dtype``); the stack with ``AttnMaskType.padding`` and the
padding mask turned into a [b, 1, s, s] attention mask (True = masked);
``final_layernorm`` on fp32; the MLM head (``lm_dense``, tanh-form gelu
in fp32, ``lm_layernorm`` on fp32, an untied ``lm_head`` [hidden, vocab]
with bf16 x bf16 products accumulated in fp32); the NSP head
(``pooler`` with tanh over the first token, ``binary_head``). A step is

    mlm, nsp = model(tokens, padding_mask, tokentype_ids)
    loss = bert_loss_fn(mlm, nsp, labels, loss_mask, nsp_labels)
    loss.backward(); opt.step(); opt.zero_grad()

As in JAX, a padded position's query row has every key masked, and the
masked softmax gives that row NaN (0 / 0): with any padding the loss is
NaN, on both packages.
"""

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.transformer_lm import (
    ParallelTransformer,
    TransformerConfig,
)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    vocab_parallel_cross_entropy,
)


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``kernel`` [in, out] and ``bias`` [out] in
    ``params_dtype``; the input is promoted to the kernel's dtype (a bf16
    input and fp32 weights give an fp32 product and output)."""

    def __init__(self, in_features, out_features, params_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=params_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=params_dtype,
                                             device=device))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class BertModel(nn.Module):
    """Bidirectional encoder: ``forward(tokens [b, s], padding_mask [b, s]
    (1 = keep), tokentype_ids [b, s], position_ids)`` -> (MLM logits [b,
    s, vocab] fp32, NSP logits [b, 2] fp32 or None)."""

    def __init__(self, config: TransformerConfig, num_tokentypes=2,
                 add_binary_head=True, device=None):
        super().__init__()
        if config.attn_mask_type != AttnMaskType.padding:
            raise ValueError(
                "BERT is bidirectional: config.attn_mask_type must be "
                "AttnMaskType.padding (got causal; the transformer stack "
                "would silently apply a causal mask)")
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        pdt, h = cfg.params_dtype, cfg.hidden_size
        self.word_embeddings = VocabParallelEmbedding(cfg.vocab_size, h, pdt,
                                                      device)
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, h, dtype=pdt, device=device))
        self.tokentype_embeddings = (nn.Parameter(torch.empty(
            num_tokentypes, h, dtype=pdt, device=device))
            if num_tokentypes else None)
        self.transformer = ParallelTransformer(cfg, device=device)
        self.final_layernorm = FusedLayerNorm(h, eps=cfg.layernorm_epsilon,
                                              device=device)
        self.lm_dense = Dense(h, h, pdt, device)
        self.lm_layernorm = FusedLayerNorm(h, eps=cfg.layernorm_epsilon,
                                           device=device)
        self.lm_head = nn.Parameter(torch.empty(h, cfg.vocab_size, dtype=pdt,
                                                device=device))
        if add_binary_head:
            self.pooler = Dense(h, h, pdt, device)
            self.binary_head = Dense(h, 2, pdt, device)
        else:
            self.pooler = self.binary_head = None

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.weight.device

    def forward(self, tokens, padding_mask=None, tokentype_ids=None,
                position_ids=None):
        cfg = self.config
        compute = cfg.compute_dtype
        h = self.word_embeddings(tokens)
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[-1],
                                        device=tokens.device)[None, :]
        h = h + self.position_embeddings[position_ids]
        if tokentype_ids is not None:
            h = h + self.tokentype_embeddings[tokentype_ids]
        h = h.to(compute).transpose(0, 1).contiguous()  # [s, b, h]
        attention_mask = None
        if padding_mask is not None:
            keep = padding_mask.bool()
            attention_mask = ~(keep[:, None, None, :] & keep[:, None, :, None])
        h = self.transformer(h, attention_mask=attention_mask)
        h = self.final_layernorm(h.float())

        x = self.lm_dense(h.to(compute))
        x = F.gelu(x.float(), approximate="tanh").to(compute)
        x = self.lm_layernorm(x.float()).to(compute)
        # bf16 x bf16 products accumulated in fp32, as the JAX head's
        # einsum with preferred_element_type=float32
        mlm_logits = torch.matmul(x.float(), self.lm_head.to(compute).float())
        mlm_logits = mlm_logits.transpose(0, 1)

        nsp_logits = None
        if self.binary_head is not None:
            pooled = torch.tanh(self.pooler(h[0].to(compute)).float())
            nsp_logits = self.binary_head(pooled.to(compute)).float()
        return mlm_logits, nsp_logits


def bert_loss_fn(mlm_logits, nsp_logits, labels, loss_mask, nsp_labels=None):
    """Masked-LM cross entropy averaged over ``loss_mask`` (at least one
    token in the denominator), plus the NSP cross entropy when
    ``nsp_logits`` and ``nsp_labels`` are given."""
    loss_mask = loss_mask.float()
    mlm_losses = vocab_parallel_cross_entropy(mlm_logits, labels)
    lm_loss = torch.sum(mlm_losses * loss_mask) / torch.clamp(
        torch.sum(loss_mask), min=1.0)
    if nsp_logits is not None and nsp_labels is not None:
        nsp_logp = nsp_logits - torch.log(
            torch.sum(torch.exp(nsp_logits), dim=-1, keepdim=True))
        nsp_loss = -torch.mean(torch.gather(nsp_logp, -1,
                                            nsp_labels[:, None].long()))
        return lm_loss + nsp_loss
    return lm_loss
