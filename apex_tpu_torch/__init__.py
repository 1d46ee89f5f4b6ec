"""apex_tpu_torch: the PyTorch + CUDA port of apex_tpu for NVIDIA Hopper.

The package mirrors ``apex_tpu``'s layout and names; every TPU kernel it
ports is a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` for
sm_90a at first use (:mod:`apex_tpu_torch.kernels._build`). Importing
the package builds nothing and touches no GPU. Entry points run on the
card unless the caller asks for the CPU, where each kernel wrapper takes
its plain PyTorch version.

Ported so far, for GPT-2-shaped (learned positions, LayerNorm, gelu)
and Llama-shaped (RoPE, RMSNorm, GQA, SwiGLU) decoder LMs: KV-cache
generation (``models.generate``) and the training step with flash
attention on or off (``GPTModel`` without a cache,
``models.gpt_loss_fn``, ``optimizers.FusedAdam``); BERT pretraining
(``models.BertModel``, ``models.bert_loss_fn``,
``optimizers.FusedLAMB``); flash attention itself (``contrib.fmha``)
and the multi-head attention modules (``contrib.multihead_attn``).
"""

__version__ = "0.1.0"
