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
and the multi-head attention modules (``contrib.multihead_attn``);
speculative generation (``models.speculative_generate``) and the
continuous-batching serving engine (``serving.ServeEngine``,
``serving.Scheduler``) with a bf16 or int8 KV cache; DeepSeek MLA
(``models.DeepseekModel``); and data parallelism on
``torch.distributed`` (``parallel``: ``DistributedDataParallel`` with
bf16, int8 or int4 gradient sync and error feedback, the compressed
collectives of ``parallel.compression``, ``SyncBatchNorm``, ``LARC``,
``parallel.multiproc.initialize_distributed`` and its launcher); tensor
parallelism (``transformer.tensor_parallel``, ``parallel.mesh2d``); and
ZeRO (``contrib.optimizers.DistributedFusedAdam``,
``DistributedFusedLAMB``) with the overlapped backward/collective step
(``parallel.OverlappedDataParallel``, ``parallel.overlapped_zero_step``);
and amp (``amp.initialize`` O0-O3, the dynamic ``amp.LossScaler``,
``amp.AmpOptimizer``, O1's dtype policy and ``amp.functional`` shim,
``transformer.amp.GradScaler``) with the optimizers it drives
(``optimizers.FusedSGD``, ``FusedMixedPrecisionLamb``,
``FusedAdam(master_weights=True)``) and ``multi_tensor_apply``; the
rest of the optimizers (``optimizers.FusedNovoGrad``, ``FusedAdagrad``,
the two public LAMB stages of ``ops``), ``fp16_utils``
(``FP16_Optimizer``, its conversions and loss scalers) and the
deprecated ``contrib.optimizers`` set.
"""

__version__ = "0.1.0"
