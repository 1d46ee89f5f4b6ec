"""Contributed kernels and modules: GQA decode attention, flash
attention (``fmha``) and the multi-head attention modules."""

from apex_tpu_torch.contrib.fmha import FMHA, attention_reference, flash_attention
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)

__all__ = ["EncdecMultiheadAttn", "FMHA", "SelfMultiheadAttn",
           "attention_reference", "flash_attention"]
