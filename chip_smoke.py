#!/usr/bin/env python3
"""Drive apex_tpu_torch's serving paths and training steps on one NVIDIA
GPU and hold each of its CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py kernels        # build + kernel checks only
    python3 chip_smoke.py gpt2_training  # any subset of the phases
    python3 chip_smoke.py serve_bf16 serve_int8 serve_spec
    python3 chip_smoke.py serve_bf16 serve_int8 serve_int8 serve_bf16
                                         # phases run in the order given

Phases (any failure exits non-zero; nothing is caught and passed over;
each prints its seconds as ``chip_smoke: phase NAME S s``):

1. build: compile every ``apex_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, all started together) and print the build time,
   ptxas's register and shared-memory report (failing where a kernel of
   NO_SPILL spills), and the card's name and power limit.
2. kernels: call each kernel's wrapper on tensors on the card at the
   shapes the serving path gives it (TinyLlama-1.1B: batch 8, prompt
   128, 32 query heads in 4 KV groups, head dim 64, hidden 2048, a
   2048-row cache), hold the result against the plain version on the
   same inputs within a stated tolerance, also on the options the path
   does not take (window, softcap, ragged T, head dim 128, fp32), and
   time kernel, plain version and one PyTorch library call as yardstick.
   The training kernels likewise at the training step's shapes (RMSNorm
   backward-dx [2048, 2048] bf16, also on each branch of its launch plan,
   with its first design and the register path at 2, 4 and 8 warps a row
   timed through the C function at [2048, 2048] and [4096, 2048] in turns,
   and _fused_rms_norm_backward as yardstick; causal softmax forward and
   backward [64, 1024, 1024] fp32, the backward on each branch of its
   plan and its register path timed beside its first design there and
   at rows of 256, 512 and 768 keys, in turns; Adam over TinyLlama's 179
   fp32 tensors) and
   off them (fp32, bf16, sk > sq, 16384 keys, L2 decay, the noop flag,
   more tensors than one launch takes). The flash kernels at the flash
   training step's shape ([2, 32, 2048, 64] fp32, causal; and bf16), at
   the MHA phase's bf16 [8, 16, 512, 64] (not causal) and off the path
   (full, windows, ALiBi, head dims 128 and 256, scales off a power of
   two, tails, one head, a do and a q off a 16-byte boundary), forward
   and backward on the bodies the wrappers pick (``fmha.fwd_plan`` and
   ``bwd_plan``: tensor cores for head dims 64 and 128, the first design
   for 256 or a misaligned operand; asserted), each run twice and
   bit-identical, window 1's dq and dk held to the float64 truth
   (FLASH_W1_ULPS); at the path shape the first designs timed through
   the C functions beside the tensor-core bodies, two planted faults in
   each kernel (the lo terms dropped, the last tile of each causal range
   skipped) that must read past FLASH_TOL, SDPA's backward profiled, and
   the pair (with and without the delta pass) beside it. LayerNorm forward and
   backward-dx at GPT-2's [8192, 1024] bf16 rows (each also on each
   branch of its launch plan, the forward also at BERT's heads' and the
   MHA norm-add's fp32 rows, each first design timed through the C
   function, and two planted faults in each, the weight read one element
   ahead and eps raised until rstd moves by about 1 %, that must read
   past LN_RTOL), the scaled and masked softmax at BERT-large's [64, 16,
   128, 128] fp32 scores with a [64, 1, 128, 128] mask (off the path:
   partial masks, fully masked rows, which are NaN as in JAX, uint8
   masks, 16384 keys, one case for each branch of the launch plan, a
   view off a 16-byte boundary; at the path shape the first design's
   block path timed through the C function beside the register path,
   and two planted faults, the mask read one key off and the scale 1e-4
   too large, that must read past the softmax tolerance), the softmax
   backward at the same shape (its first design timed beside the register
   path, two planted faults: the butterfly's last step skipped, dy read
   one key ahead), LAMB over BERT-large's 302 tensors (off the path:
   L2 decay, no clip, noop). The int8 block quantize and dequantize
   kernels bit for bit at the serving store's [16384, 256] rows (8 slots
   x 2048 positions of one K or V leaf), at one position per slot and on
   ragged rows and blocks; the dequantize on every branch of its plan
   (its streaming body also equal to its first design, codes at a 4-byte
   offset, two planted faults that must not be equal), its first design
   timed beside it; the int8-cache verify kernel at the TinyLlama
   verify window (w 5, g 4, rep 8, d 64) over a 2048-position int8 store
   with each slot at its own start, and with padding lanes (g*d < nb*B);
   the window and decode kernels with per-row starts and lengths, at the
   engine's other shapes (the verify window at mixed starts, the smallest
   prefill bucket, a full 2048-row slot, batch 2), and through their C
   functions with the split count forced to 1, to the planned count and
   to 16, with planted faults (starts or lengths one key short) that must
   read past ATTN_TOL. The
   MLA latent decode kernel at ``bench.py mla_decode``'s step (q [8, 16,
   576] bf16 over a [4608, 8, 576] bf16 latent cache) at lengths across
   its steps, stages and splits, and off the path: an fp32 cache and
   queries, 1280-, 512- and 40-row buffers, 128 heads, per-row lengths,
   dead rows holding 1e4 (bit-identical to clean ones), narrower latents
   and other row widths, each case's plan branch asserted; the
   tensor-core body run twice bit-identical, and at both MLA paths' steps
   two planted faults (the last live split dropped, the rope columns left
   out) that must read past MLA_TOL, the first design timed beside it and
   the sweep of its split sizes; RMSNorm
   on fp32 rows of width 512, 1024 and 2048 into bf16 (the MLA models'
   norms). The int4 quantize, dequantize, pack and unpack kernels bit for
   bit at GPT-2 345M's largest gradient bucket ([201216, 256] fp32) and
   the MLP's ([16400, 256]), and off the path (odd widths, zero and
   clipped blocks, one row, unpack's n); the int8 quantize on given
   scales and the int8 dequantize on int32 totals at the GPT-2 bucket.
   The TP GEMM at GPT-2 345M's two row-parallel tiles ([8192, 4096] and
   [8192, 1024] fp32 against a strided 256-column tile of wo) and at
   tp_dp's ([128, 1024] and [128, 256] against a strided 64-column tile),
   each on its launch plan (logged; split K at tp_dp's) and at forced
   split counts, held per element to TP_MATMUL_TOL of |x| @ |w|, two runs
   bit-identical, with two planted faults at each that must read past
   it, and off the path (ragged rows, N and K, one row, bf16 x or w, a
   3-D x, strided rows of x, a w view off 16 bytes).
   Malformed CUDA inputs to every wrapper are refused and not counted.
3. serving: ``GPTModel`` at TinyLlama-1.1B width (22 layers, seeded
   random weights) and ``generate(batch 8, prompt 128, 32 new tokens,
   greedy)`` with every launch count set to 0 just before and read just
   after; the prefill and first decode step's logits against the same
   model run through the plain versions on the card; prefill ms and
   decode tokens/s.
3a. serve_bf16, serve_int8, serve_spec: ``serving.ServeEngine`` at
   TinyLlama-1.1B width and depth (seeded random weights, bf16
   activations) serves ``bench.py bench_serve_decode``'s trace at steps
   = 32 (16 requests, prompts of 8-96 tokens, 16-64 new tokens, greedy;
   8 slots, batch buckets 2/4/8, prefill buckets 32/64/128) after a
   4-request warm-up, with every launch count set to 0 just before and
   read just after: each request finishes, the counts equal the engine's
   per-step and per-prefill launches, and the streams match the same
   engine's through the plain versions (where two streams differ, the
   top-2 logit margin at the first differing token must be below
   LOGIT_TOL). serve_int8 also prints the stores' bytes and holds the
   dequantized int8 store to absmax/254 of the bf16 store after one
   prefill; serve_spec (bench.py ``_serve_spec_setup``: layers past the
   first scaled by 0.25, a 1-layer draft sharing the embedding, layer 0,
   final norm and head, 4 draft tokens a round, bf16 cache) holds its
   streams to the plain engine's on the same model. Tokens/s, TTFT and
   per-token latency p50/p99, decode steps, prefill calls, and a profile
   of one decode step (or round) of a full bucket.
4. training: the same model with ``use_flash_attention=False`` takes
   three ``FusedAdam(lr=1e-4)`` steps on a seeded batch of 2 x 1024
   tokens, the counts set to 0 before each step and checked after it;
   the loss must fall; step 1 (loss, every gradient, every update) is
   held against the same step through the plain versions on the card;
   step ms, tokens/s, peak memory and a profile of one step.
5. flash_training: the same, with ``use_flash_attention=True`` (the
   JAX model's default) at TinyLlama's pretraining length, 2 x 2048
   tokens: each step launches each flash kernel once per layer and the
   causal softmax kernels not at all.
6. gpt2_training: GPT-2 345M (24 x 1024, 16 heads, vocab 50304, learned
   positions, LayerNorm, gelu, untied head) as ``bench.py bench_gpt2``
   trains it: 8 x 1024 tokens, flash on, ``FusedAdam(lr=1e-4)``, with
   the same counted, timed and step-1 checks: LayerNorm forward and
   backward-dx (49 each a step), the flash kernels (24 each), Adam.
7. bert_training: BERT-large (24 x 1024, 16 heads, vocab 30528) as
   ``bench.py bench_bert`` trains it: 64 x 128 tokens, the padding mask
   type with an all-ones padding mask, token types 0, a 15 % loss mask,
   MLM + NSP loss, ``FusedLAMB(lr=1e-3, weight_decay=0.01)``: LayerNorm
   (50 each way a step), the masked softmax and softmax backward (24
   each), LAMB; then one forward and backward without a padding mask,
   through the scaled softmax kernel, to the same loss.
8. mha: ``SelfMultiheadAttn`` at BERT-large width (h 1024, 16 heads,
   s 512, batch 8, bf16, ``impl="fast"``) forward and backward through
   the non-causal flash kernels, counted, and held against the same
   module through the plain versions; then with ``include_norm_add``
   (one LayerNorm forward and backward-dx more).
9. mla_decode: ``DeepseekModel`` at ``bench.py bench_mla_decode``'s
   shapes (4 x 1024, 16 heads, kv latent 512 + rope 64, ffn 2816, vocab
   32000, a 4608-row latent cache, fp32 weights, bf16 compute, seeded
   random weights): a prefill of 8 x 4096 tokens, one warm step and 64
   timed greedy steps, counted (13 RMSNorm launches a forward; 4 of the
   MLA decode kernel a step, none a prefill); the same steps on the
   model's einsum branch as the yardstick; prefill and step-1 logits
   held to the plain versions', and the greedy streams: where one
   differs, each run's own logits rank its token above the other's by
   less than LOGIT_TOL; step 1 again with each planted fault of
   MLA_FAULTS (the MLA decode's through its own launch), which must read
   past the logits limits;
   prefill ms, step ms, tokens/s and profiles of a step both ways.
10. deepseek_v2_lite: DeepSeek-V2-Lite's published widths and depth
   (27 layers, hidden 2048, layer 0 dense, 26 MoE layers of 64 routed
   experts top-6 plus 2 shared, 15.7 B bf16 parameters, seeded random
   weights, plain RoPE): ``mla_cached_generate`` of 8 x 512 prompt
   tokens and 32 greedy tokens, counted (82 RMSNorm a forward, 27 MLA
   decode a step); prefill ms, step ms, tokens/s, peak memory, a profile
   of one step; logits and streams held to the plain versions' as in
   mla_decode, the kernel run's decode replayed bit-exactly, and the
   share of the prefill's top-6 expert choices the two runs share.
11. ddp_gpt2: GPT-2 345M as in phase 6 on a one-rank NCCL group
   (``multiproc.initialize_distributed()``), with
   ``DistributedDataParallel(axis_name="dp", compress=mode).sync`` between
   backward and the optimizer's step (39 buckets of at most 10 M elements
   in registration order, the residual carried from step to step, the
   synced gradients back in ``p.grad``) for every mode (none, bf16, int8,
   int4): counted steps (each bucket one #14 or #16 and one #15 in the
   int modes, none in the others; the model's kernels as in phase 6),
   step ms, tokens/s, the sync's ms (CUDA events; its kernels under the
   profiler), NCCL's share, peak memory, step 3's loss and the modeled
   wire bytes; the last counted step's sync held bit-identical to its
   plain route and, at world 1, synced + new residual to g + old residual
   within one fp32 ulp; then ``psum_scatter_compressed`` (int8, int4) on
   the flat gradient vector and ``all_gather_compressed`` (bf16, int8,
   int4) on the flat parameter vector, each counted and held bit-identical
   to its plain route, the int4 gather within half a step of its grid.
12. ddp_compressed: ``bench.py bench_ddp_compressed`` as it stands (a 4 x
   1024 tanh MLP, batch 64, RandomState(0), w - 0.05 g, one bucket) in
   int8 and int4: counted steps, 30 timed steps, steps/s, the loss falls.
13. zero_gpt2: GPT-2 345M as in phase 6 on a one-rank NCCL group with
   ``contrib.optimizers.DistributedFusedAdam(lr=1e-4, compress=True)``
   (behind ``_ZeroOpt``: the new params copied into the model): counted
   steps (#12 once a step, on the flat vector), the step-1 hold against
   the plain versions, timed steps, peak memory, a profile;
   ``state_bytes`` at world 1 and 8; ``state_dict_full`` ->
   ``load_state_dict_resharded`` bit-exact; step 1 against FusedAdam's
   from the same gradients (bit-identical). Then
   ``parallel.overlapped_zero_step`` over mesh2d's GPT-2 345M segments (24
   layers, 8 x 1024 tokens, 1 x 1 mesh) with
   ``DistributedFusedAdam(overlap=True, compress=True)``: counted steps
   (#12 once a bucket), timed steps, the profiler ranges in emission
   order (segment k's buckets before segment k - 1's backward), step 1
   against the plain versions and against the monolithic ZeRO step on the
   whole model's gradients (bit-identical).
14. zero_bert: BERT-large as in phase 7 with
   ``DistributedFusedLAMB(compress=True)`` and bench_bert's LAMB settings:
   counted steps (#13 once a step), the step-1 hold, timed steps, peak
   memory, a profile; step 1 against FusedLAMB's from the same gradients
   within one ulp plus ZERO_VS_FUSED_LAMB_RTOL of each update.
15. tp_dp: ``parallel.mesh2d``'s 2-D step as ``bench.py bench_tp_dp``
   builds it (hidden 256, 4 layers, 8 heads, vocab 256, 32 positions,
   batch 4, int8 on "data", lr 0.05) on a 1 x 1 mesh over a one-rank NCCL
   group, in mode "baseline" and "overlapped" (JAX's default), fused off
   and on in each: counted steps (#20 32 a step fused, 0 unfused; one #14
   and #15 a bucket), 10 timed steps, steps/s, the TP all-reduces and
   their host time, a profile, and each mode's two runs' losses held step
   by step, the overlapped runs' equal to the baseline's; the baseline
   pair with an fp32 sync, held at every step to step 1's limit, and the
   fused baseline run with each of two planted #20 faults, which must
   fail the int8 pair's hold.
16. tp_gpt2: the same step at GPT-2 345M's widths (24 x 1024, 16 heads,
   vocab 50304, 8 x 1024 tokens), fused: step 1's loss and six gradients
   held against the plain versions, counted steps (#20 192 a step), step
   ms, tokens/s, peak memory, a profile with #20's share of the busy
   time; the overlapped fused step counted (#14/#15 once a bucket),
   timed, profiled, its losses equal to the baseline's; one unfused
   step's loss held against the fused step 1's, and the unfused step
   timed as the fused ones, with the ratio of the two medians.
17. amp_gpt2: GPT-2 345M as in phase 6 under amp O2 as bench.py's
   bench_resnet drives amp: ``amp.initialize(model, FusedAdam(lr=1e-4),
   opt_level="O2")`` (bf16 parameters but the norms', fp32 masters owned
   by amp, the dynamic scale), the scaled loss's backward: first a bf16
   GEMM at the MLP's shape held, under the setting amp.initialize leaves,
   to the once-rounded fp32 sum (JAX's ``preferred_element_type=f32``
   then bf16), the check shown to catch a planted double rounding; then a
   fresh optimizer's two steps with an inf planted into one gradient at
   the second, which must leave the parameters, masters, moments and
   step counts bit-identical and halve the scale (2^16 to 2^15), then the
   counted (multi_tensor_scale and adam once per 64 tensors of a dtype
   a step), timed and profiled steps and the step-1 hold against the plain
   versions (each tensor's update over the entries whose gradients in the
   two runs share a sign), every ``opt.step()`` with host waits forbidden
   (``torch.cuda.set_sync_debug_mode("error")``); the step's ms, tokens/s,
   peak memory and busy share beside phase 6's.
18. amp_o1_sgd: the same model under amp O1 (fp32 parameters) with
   ``FusedSGD(lr=AMP_SGD_LR, momentum=0.9)``, BASELINE.json's "amp O1 +
   FusedSGD": the same checks (multi_tensor_scale and sgd a step).
19. amp_bert: BERT-large as in phase 7 under amp O2 with
   ``FusedMixedPrecisionLamb(lr=1e-3, weight_decay=0.01)`` (its own fp32
   masters): the same checks (multi_tensor_scale, lamb and lamb_stage2
   a step), the loss falling from step 2 as phase 7's.
20. novograd_gpt2: GPT-2 345M as in phase 6 with
   ``FusedNovoGrad(lr=NOVOGRAD_LR, betas=NOVOGRAD_BETAS,
   weight_decay=NOVOGRAD_WD)``: the counted steps (novograd once per 64
   tensors a step: two CUDA kernels each, the norms and the update), the
   loss falling, the step-1 hold against the plain versions, every
   ``opt.step()`` with host waits forbidden; ms, tokens/s, peak memory
   and busy share beside phase 6's.
21. adagrad_gpt2: the same with ``FusedAdagrad(lr=ADAGRAD_LR)`` (adagrad
   once per 64 tensors a step).
22. fp16_gpt2: GPT-2 345M in bf16 from ``fp16_utils.network_to_half``
   (the norms' fp32) with ``FP16_Optimizer(FusedAdam(lr=1e-4),
   dynamic_loss_scale=True)``: first a fresh optimizer's two steps with an
   inf planted into one gradient at the second, which
   ``update_master_grads`` reads (halving the scale, 2^32 to 2^31) and the
   step after must skip bit for bit; then the checks of phase 17
   (multi_tensor_scale and adam once per 64 tensors of a dtype a step, the
   scaled loss's backward, the masters' step-1 update held).
23. tp_serve: tensor-parallel serving at tp = 2 as two ranks sharing the
   one card over a gloo group (NCCL refuses two ranks on one device; a
   probe pair records its refusal): the parent runs tp = 1 references on
   TinyLlama-1.1B and mla_decode's model with seed-0 weights drawn on
   the host, then starts two ranks of this script (``--tp-worker DIR``)
   through the port's launcher, killing both when one fails or runs out
   of time. Each rank shards the same host-drawn weights
   (``init_params_tp``) and runs ``tensor_parallel_generate`` 8 x 128 +
   32 and ``tensor_parallel_beam_search`` (4 beams; one beam against
   greedy), the bf16 and int8 engines on serve_bf16's trace (eager:
   capture at tp 2 is refused), int8 held against its plain versions,
   the speculative + prefix engine on serve_prefix's trace and then the
   migration drill on its scaled target, as serve_prefix runs them, and
   mla_decode's model (8 of its 16 heads), each rank's launch
   counts exact and its prefill and first step held against the plain
   versions. The parent holds the two ranks bit-identical and against
   tp = 1 by the near-tie rules, and times #25, #21, #14, #15 and #26 at
   a rank's shapes alone on the card. Times are labelled as two ranks
   sharing one H100 over gloo: not a TP speed.
24. resilient_gpt2: GPT-2 345M (8 x 1024, flash) under amp O2 with
   FusedAdam on fp32 masters, driven by the resilience Supervisor: each
   step guarded (``guarded_update``: K7's statistics into a flight
   recorder, amp's found_inf OR'd in, the fused optimizer's writes
   skipped on the device), ``check_guard`` polled, the registry's JSONL
   sink on, an AsyncCheckpointer every 4 steps (keep 2), hot snapshots
   every 2. Planted once each: NaN gradients in one module (the state
   hash-equal after the step, the scale halved, the post-mortem naming
   the module), three NaN steps in a row (escalation, the snapshot
   revert with the scale backed off, the ledger verified), a synthetic
   RESOURCE_EXHAUSTED and a real CUDA OOM under ``guarded_call`` (memory
   post-mortems naming the masters and moments), a torn checkpoint write
   (restore walks back to the last verified step) and a real SIGTERM
   (one final save, a clean exit; the resumed state hash-equal to the
   unkilled one, then two more steps each). Then the guarded step with
   telemetry off and on, and ``step_cost``'s FLOPs against 6 N T plus
   flash's attention FLOPs (within FLOPS_CLOSED_FORM_RTOL), MFU <= 1.
25. serve_guarded: the TinyLlama-1.1B engine on its CUDA graphs with
   telemetry on and ``preflight=True``: serve_bf16's trace under
   ``assert_no_recompiles`` with a decode failure retried once and one
   active slot poisoned (evicted as ``poisoned``), launch counts exact,
   every request traced; ``preflight_strict`` under the measured need
   refused; tokens/s with telemetry off, on, off; then a SIGTERM after 4
   scheduler steps drains a second engine's scheduler, its pending
   requests extracted.
26. guarded_tp_dp: mesh2d's ``mode="guarded"`` at tp_dp's shapes on a 1
   x 1 mesh, fused (#20), NaN planted at step 1: that step leaves the
   shards and the int8 residual bit for bit, the others commit.

The kernel phase also holds amp's kernels against their plain versions:
multi_tensor_scale (in place over GPT-2 345M's and BERT-large's O2
gradients, a planted inf, the other dtype out, axpby over every dtype
triple, views 1-7 elements past a 16-byte boundary; its streaming body
also bit for bit against its first design, path 0, and timed beside it
through the C function in turns), adam on amp's
device step (GPT-2's O2 step with masters; off the path inv_scale, L2
decay without bias correction, bf16 parameters without masters, views
off the vector boundary, noop; the device step's bias corrections held
through the kernel's outputs at AMP_BC_STEPS), sgd (GPT-2's fp32 step,
the first run and the next; off the path nesterov, dampening, decay
before and after the momentum, bf16 gradients and outputs, views 1-3
elements past a 16-byte boundary; its streaming body also bit for bit
against its first design and timed beside it in turns), lamb and
lamb_stage2 on masters (BERT-large's O2 step; off the path inv_scale, L2
decay, no clip, no outputs, found_inf), each with two planted faults
through its own launch, timed beside its bound and, where one exists,
its PyTorch call; and the rest of the optimizers' kernels at GPT-2's 293
fp32 tensors: adagrad (both modes, decay, the scale's division, bf16
gradients and outputs, noop, views 1-3 elements past a 16-byte boundary;
bit for bit; beside torch._fused_adagrad_ where that runs on CUDA
tensors), novograd (the first step and later ones to NOVOGRAD_BC_STEPS,
the max norm, init_zero, each moment mode, v out of order; p and m bit
for bit against the plain version's pass on the kernel's v, v within
NOVOGRAD_V_RTOL of the plain version's and of float64 sums, two runs
bit-identical) and lamb's stage 1 with a decay a tensor (the public
two-stage op's route, a launch a distinct decay; kernel phase only),
each with two planted faults through its own launch, timed beside its
bound; and K7 multi_tensor_stats (GPT-2 345M's O2 gradient list by
module prefix, and 96 ragged views at 1-7 element offsets in three
dtypes over two launches): counts and absmax exact, sums of squares
within STATS_SUMSQ_RTOL, two runs bit-identical, two planted faults
caught, timed beside its bound and torch._foreach_norm. A kernel's row
in the JSON line is its first shape;
the others follow under ``other_shapes``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12
# fp32 accuracy on the TF32 tensor cores: each product as three (lo.hi,
# hi.lo, hi.hi), so "the same work" at TF32's rate is three times the ops
TF32_SPLIT_TERMS = 3

# TinyLlama-1.1B (huggingface.co/TinyLlama/TinyLlama-1.1B-Chat-v1.0,
# config.json) and the serving run
MODEL = dict(hidden_size=2048, num_layers=22, num_attention_heads=32,
             num_query_groups=4, ffn_hidden_size=5632, vocab_size=32000,
             max_position_embeddings=2048, layernorm_epsilon=1e-5,
             rotary_base=10000.0, activation="swiglu",
             normalization="rmsnorm", position_embedding_type="rope",
             tie_word_embeddings=False)
BATCH, PROMPT, NEW_TOKENS, SEED = 8, 128, 32, 0
DECODE_LENGTH = PROMPT + NEW_TOKENS // 2  # a mid-run decode step
# the training step: micro-batch 2 x 1024 tokens, FusedAdam as bench.py
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 2, 1024, 1e-4
COUNTED_STEPS, TIMED_STEPS = 3, 5
# the flash training step: TinyLlama's pretraining sequence length
FLASH_BATCH, FLASH_SEQ = 2, 2048
# SelfMultiheadAttn at BERT-large width (bert-large-uncased config.json:
# hidden 1024, 16 heads) over a batch of 8 sequences of 512
MHA_HIDDEN, MHA_HEADS, MHA_SEQ, MHA_BATCH = 1024, 16, 512, 8
# GPT-2 345M as bench.py bench_gpt2 trains it (24 x 1024, 16 heads, vocab
# 50304, seq 1024, batch 8, flash on, FusedAdam(lr=1e-4), no amp); the
# remaining TransformerConfig fields are JAX's defaults (learned
# positions, gelu, LayerNorm, untied head)
GPT2 = dict(hidden_size=1024, num_layers=24, num_attention_heads=16,
            vocab_size=50304, max_position_embeddings=1024)
GPT2_BATCH, GPT2_SEQ, GPT2_LR = 8, 1024, 1e-4
# BERT-large as bench.py bench_bert trains it (24 x 1024, 16 heads, vocab
# 30528, 512 positions, seq 128, batch 64, padding mask type, flash off,
# FusedLAMB(lr=1e-3, weight_decay=0.01), no amp)
BERT = dict(hidden_size=1024, num_layers=24, num_attention_heads=16,
            vocab_size=30528, max_position_embeddings=512)
BERT_BATCH, BERT_SEQ, BERT_LR, BERT_WD = 64, 128, 1e-3, 0.01
BERT_EPS, BERT_MAX_GRAD_NORM = 1e-6, 1.0  # FusedLAMB's defaults, bench_bert's
# the serving engine as bench.py bench_serve_decode drives it (steps = 32):
# 8 slots, batch buckets (2, 4, 8), prefill buckets (32, 64, 128), 16
# requests of synthetic_trace(seed 1, Poisson arrivals 1 tick apart,
# prompts of 8-96 tokens, 16-64 new tokens), greedy; the speculative
# engine as bench_serve_spec: 4 draft tokens a round
SERVE_SLOTS, SERVE_BATCH_BUCKETS = 8, (2, 4, 8)
SERVE_PREFILL_BUCKETS = (32, 64, 128)
SERVE_REQUESTS, SERVE_SEED = 16, 1
SERVE_PROMPT_LENS, SERVE_MAX_NEW = (8, 24, 48, 96), (16, 32, 64)
SPEC_K = 4
# the prefix-cached speculative engine as bench.py bench_serve_spec drives
# it at full size (bench.py:2999-3127): batch buckets (2, 4, 8), prefill
# buckets (64, 128), 8 slots, 4 draft tokens, prefix_min_len 6, 16
# entries; 16 requests of synthetic_trace (Poisson arrivals 0.1 tick
# apart, a 40-token system prompt opening 80 % of them before an 8/16/24-
# token tail, 32 or 48 new tokens), a warm-up trace (seed 0) before the
# measured one (seed 1); the migration drill's donor takes MIGRATE_TICKS
# scheduler steps before its unfinished requests move
PREFIX_BUCKETS = (64, 128)
PREFIX_SHARED, PREFIX_TAILS, PREFIX_MAX_NEW = 40, (8, 16, 24), (32, 48)
PREFIX_MIN_LEN, PREFIX_ENTRIES, MIGRATE_TICKS = 6, 16, 6
# the serving phase's beam search (4 beams a row of the 8 x 128 prompt)
# and shared-prefix generate (a 512-token prefix, 8 suffixes of 64)
BEAMS, SHARED_PREFIX, SUFFIX = 4, 512, 64
# DeepSeek MLA, dense, at bench.py bench_mla_decode's shapes (bench.py:
# 1031-1039): 4 x 1024, 16 heads, kv latent 512 + rope 64, fp32 params,
# bf16 compute; batch 8, a 4096-token prompt, one warm step, 64 timed
# greedy steps, a 4608-row cache (4096 + 64 + 2 rounded up to 512)
MLA_DECODE_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=4,
                      num_heads=16, q_lora_rank=None, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128, ffn_hidden_size=2816,
                      max_decode_length=4608)
MLA_BATCH, MLA_PREFIX, MLA_STEPS = 8, 4096, 64
MLA_DECODE_LENGTH = MLA_PREFIX + 1 + MLA_STEPS // 2  # a mid-run step
# DeepSeek-V2-Lite's published widths and depth (huggingface.co/
# deepseek-ai/DeepSeek-V2-Lite config.json: 27 layers, hidden 2048, 16
# heads, no q latent, kv latent 512, nope 128, rope 64, v 128, dense ffn
# 10944 in layer 0, 64 routed experts of 1408 top-6 with raw softmax
# gates, 2 shared experts, vocab 102400), plain RoPE (its YaRN scaling
# is not an MLAConfig field), bf16 params and compute; batch 8, a
# 512-token prompt, 32 greedy tokens through mla_cached_generate
V2_LITE_CFG = dict(vocab_size=102400, hidden_size=2048, num_layers=27,
                   num_heads=16, q_lora_rank=None, kv_lora_rank=512,
                   qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                   ffn_hidden_size=10944, n_routed_experts=64,
                   moe_intermediate_size=1408, n_shared_experts=2,
                   moe_top_k=6, first_k_dense_replace=1,
                   routed_scaling_factor=1.0, norm_topk_prob=False,
                   rms_eps=1e-6, rotary_base=10000.0, max_decode_length=1024)
V2_BATCH, V2_PROMPT, V2_NEW = 8, 512, 32

# Tolerances, kernel against plain version on the same inputs:
# RMSNorm: the same fp32 operations with the sum in another order, so a
# bf16 output may round the other way: one bf16 ulp (2**-7 relative).
NORM_RTOL, NORM_ATOL = 2.0 ** -7, 1e-6
# ...but only where the fp32 value lies within its last-place difference
# of a bf16 rounding boundary: a few in 10**6 outputs (0-3.9e-6 on an
# H100 80GB HBM3). A bf16 output rounded toward zero differs in about
# half (0.50 there), within NORM_RTOL all the same, so the share that
# differs is held too.
NORM_DIFFER_SHARE = 1e-3
# attention: fp32 scores, softmax and sums over up to 2048 keys in
# another order; outputs of magnitude ~1.
ATTN_TOL = 1e-4
# logits of the 22-layer bf16 model, kernels against plain versions:
# every bf16 rounding of the residual stream that flips after an fp32
# difference in the last place propagates through the later layers;
# logits have a standard deviation of ~1.
LOGIT_TOL = 0.25
# RMSNorm backward-dx: fp32 row sums in another order and rsqrtf against
# torch.rsqrt; dx = (w*dy - xhat*c)*rstd cancels where w*dy ~ xhat*c, so
# the absolute part is 1e-5 of the largest |dx|; bf16 may round either
# way: one bf16 ulp.
NORM_BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# softmax forward: the same fp32 operations (expf, IEEE division) with
# the row max and sum taken in another order; probabilities <= 1.
SOFTMAX_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SOFTMAX_ATOL = 1e-6
# softmax backward: scale*y*(dy - sum(dy*y)) cancels where dy ~ the sum:
# the absolute part is 1e-5 of the largest |dx|.
SOFTMAX_BWD_RTOL = SOFTMAX_RTOL
# Adam: the same fp32 operations in the same order, elementwise with no
# sums, so the kernel is expected to equal the plain version bit for bit;
# held within 2 fp32 ulps.
ADAM_RTOL = 2.0 ** -22
# the training step, kernels against plain versions on the same weights
# and batch (bf16 activations, 22 layers): the step-1 loss within 1e-3
# relative; each gradient within 5e-2 relative (Frobenius): a bf16
# rounding that flips after an fp32 difference in the last place flows
# back through the layers. Adam's first step is lr * g / (|g| + eps),
# lr * sign(g) for all but the smallest entries, so the two updates
# differ only where the two gradients' signs do: a share f of such
# entries gives a relative update error of 2 * sqrt(f). Only entries
# whose |g| lies within the gradients' difference can flip, some 4 % of
# them at a 5e-2 difference, hence 0.4 over all parameters and 0.5 for
# each (a wrong or missing update is off by 1 or more).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 5e-2
TRAIN_UPDATE_RTOL, TRAIN_TENSOR_UPDATE_RTOL = 0.4, 0.5
# LAMB's step 1 on BERT-large: loss and gradients as above. Its first
# update is u = h / (|h| + eps) + wd * p with h = g / clip (m / bc1 = h
# and v / bc2 = h*h at step 1), moved by lr * ||p|| / ||u|| per tensor.
# Where |h| >> eps = 1e-6 it is sign-like, as Adam's; where |h| <~ eps it
# is linear in h, and there a gradient difference moves it by as much
# and no more. BERT-large's entries that flip sign between the two runs
# are of that second kind (measured: 7.6e-3 of the entries flip, yet the
# update differs by 1.8e-2 over all parameters, not 2 * sqrt(f) = 0.17),
# so the update is held to the gradients' own 5e-2 over all parameters
# and to 0.25 per tensor (measured at most 9.9e-2, the token-type
# embeddings, whose second row has no gradient): 2.5x the measured
# values, and 0.16 under what flips of sign-like entries would give.
LAMB_UPDATE_RTOL, LAMB_TENSOR_UPDATE_RTOL = TRAIN_GRAD_RTOL, 0.25
# flash attention, kernel against plain version on the same inputs, as
# (rtol, absolute part as a share of the largest |want|):
# fp32 O: fp32 sums over up to 2048 keys and 64 dims in another order,
# outputs of magnitude ~1: 1e-4 (as ATTN_TOL). lse (values ~8): the same
# sums inside a log, 1e-5 relative. Gradients: the same sums, and ds =
# p * (dp - delta) cancels where dp ~ delta, so the absolute part is
# 1e-4 of the largest |gradient|. bf16 O and gradients are rounded from
# fp32 values that may differ in the last place: one bf16 ulp, 2**-7
# relative, and 2**-8 of the largest magnitude for entries near 0.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}
FLASH_LSE_RTOL = 1e-5
# One case is held otherwise, by name: with window 1 every query sees only
# its own key, p = 1 and o = v, so ds = do.v - delta is exactly 0 and so
# are dq = ds k scale and dk = ds q scale; what a kernel returns there is
# the rounding of the two d-term sums behind ds, and a share of the plain
# version's largest |dq| (itself such rounding) measures nothing. There dq
# and dk are held to the true answer, softmax attention's gradients in
# float64, within FLASH_W1_ULPS fp32 ulps (2**-23) of those sums' scale:
# |dq[i, c]| <= ulps * 2**-23 * sum_j |do[i, j] v[i, j]| * |k[i, c]| *
# scale, dk's with q[i, c]. Two fp32 sums of d = 64 products, each product
# three TF32 terms (up to 6 ulps off), accumulated on the tensor cores,
# stay within a few ulps of that scale, far from its worst case of ~70.
FLASH_W1_ULPS = 16
# LayerNorm forward and backward-dx: as RMSNorm's (the same fp32
# operations, row sums in another order, rsqrtf against torch.rsqrt);
# one bf16 ulp where the output is bf16; dx cancels where w*dy ~ its
# row means: an absolute part of 1e-5 of the largest |dx|.
LN_RTOL = NORM_BWD_RTOL
# LAMB stage 1: elementwise, the same fp32 operations in the same order,
# expected bit-identical to its plain version; held within 2 fp32 ulps.
LAMB_RTOL = ADAM_RTOL
# the multi-head attention module, kernels against plain versions: bf16
# context entries one ulp apart (2**-8 relative) pass through the bf16
# output projection and its backward: 1e-2 relative (Frobenius).
MHA_RTOL = 1e-2
# the MLA decode kernel against its plain version: fp32 scores over 576
# columns (q scaled before the dot in the kernel, after it in the plain
# version, one rounding apart), softmax and sums over up to 4608 rows in
# another order, outputs convex combinations of rows of magnitude ~1:
# 1e-4 absolute and relative, as ATTN_TOL.
MLA_TOL = ATTN_TOL
# the MLA models' logits, kernels against plain versions on the same
# weights: in the prefill only the RMSNorm kernel differs from its plain
# version (one bf16 ulp of its outputs, as NORM_RTOL), in a step from the
# kernels' own prefix also the decode kernel (fp32 sums in another
# order, rounded to bf16); those flips propagate through mla_decode's 4
# bf16 layers as through TinyLlama's 22: LOGIT_TOL. In deepseek_v2_lite
# they also flip near-tied expert choices (1.1 % of the prefill's top-6
# choices on an H100 80GB HBM3): a token whose sixth expert changes
# swaps that expert's output, weighted by a gate near the fifth and
# seventh (~1/64 of the mass), for another's, a step in the residual
# stream far above a bf16 ulp, which 26 MoE layers compound. There the
# prefill's 419 M logits (std 0.9) read 0.2365 against their plain
# version and 2.27 with a planted RMSNorm fault (MLA_FAULTS); they are
# held to MOE_LOGIT_TOL, between the two. Step 1 reads 0.149 (and
# mla_decode's 0.035) against 0.389-2.69 with planted faults, so both
# phases hold it to LOGIT_TOL. The MLA phases hold their greedy streams
# with each run's own logits (see _near_tie_check): re-prefilling a
# context, as the serve phases do, routes its tokens through other bf16
# roundings than the steps did.
MOE_LOGIT_TOL = 2 * LOGIT_TOL
# the TP GEMM #20 against its plain version (torch.matmul in fp32, TF32
# off) on the same inputs: both sum the same fp32 products over k, each
# in its own order, so two sums differ by a few fp32 roundings of the
# partial sums, which |x| @ |w| bounds: per element |got - want| <= 1e-6 *
# (|x| @ |w|) (2**-23 = 1.2e-7 is one rounding of the whole magnitude).
# The last 16 K terms skipped, or a column tile shifted by one, reads
# far past it (TP_MATMUL_FAULTS). A bf16 output is the kernel's fp32 sum
# rounded to nearest: it must equal, bit for bit, that rounding of the
# same kernel's fp32 output on the inputs widened to fp32 (exact), and
# that output is held to the plain version's fp32 sum as above. (Against
# the plain version's own bf16 output, two roundings of sums that differ
# in the last fp32 place land one bf16 ulp apart now and then.)
TP_MATMUL_TOL = 1e-6


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def card_state():
    """The card's clocks, power draw, temperature and (where this
    nvidia-smi knows the field) active clock-event reasons, as nvidia-smi
    reads them now: a note beside a timing, never a check."""
    base = "clocks.sm,clocks.mem,power.draw,temperature.gpu"
    for fields in (base + ",clocks_event_reasons.active", base):
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True)
        if out.returncode == 0:
            return f"{fields}: {out.stdout.strip().splitlines()[0]}"
    return "not read"


def device_ms(fn, iters=20, replays=5):
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def call_ms(fn, iters=50, warmup=5):
    """Time of one eager call of ``fn`` in ms, host launch included: CUDA
    events around ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, ops_per_s):
    """(least ms, what bounds it) for ``nbytes`` moved once and ``ops``
    operations at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def max_rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


@contextlib.contextmanager
def plain_versions():
    """Route the model's and the optimizer's kernel calls to their plain
    versions (for the reference runs on the card). The wrappers are
    swapped in their modules, so the autograd Functions and the
    optimizer that call them stay the same."""
    from apex_tpu_torch.contrib import fmha, gqa_decode, mla_decode
    from apex_tpu_torch.kernels import (
        fused_cc,
        norm,
        optim,
        quant,
        quant4,
        scale,
        softmax,
    )
    swaps = [(norm, "rms_fwd", norm.rms_fwd_plain),
             (quant4, "quantize_int4", quant4.quantize_int4_plain),
             (quant4, "dequantize_int4", quant4.dequantize_int4_plain),
             (quant4, "pack_int4", quant4.pack_int4_plain),
             (quant4, "unpack_int4", quant4.unpack_int4_plain),
             (quant4, "quantize_pack_int4", quant4.quantize_pack_int4_plain),
             (quant4, "unpack_dequantize_int4",
              quant4.unpack_dequantize_int4_plain),
             (mla_decode, "mla_flash_decode",
              mla_decode.mla_decode_reference),
             (quant, "quantize_rows", quant.quantize_rows_plain),
             (quant, "dequantize_rows", quant.dequantize_rows_plain),
             (fused_cc, "spec_verify_attention",
              fused_cc.spec_verify_reference),
             (fused_cc, "_matmul", fused_cc.matmul_plain),
             (norm, "rms_bwd_dx", norm.rms_bwd_dx_plain),
             (norm, "ln_fwd", norm.ln_fwd_plain),
             (norm, "ln_bwd_dx", norm.ln_bwd_dx_plain),
             (softmax, "scaled_softmax_fwd", softmax.scaled_softmax_fwd_plain),
             (softmax, "scaled_masked_softmax_fwd",
              softmax.scaled_masked_softmax_fwd_plain),
             (optim, "lamb", optim.lamb_plain),
             (fused_cc, "window_attention", fused_cc.window_attention_plain),
             (gqa_decode, "gqa_flash_decode", gqa_decode.gqa_decode_plain),
             (softmax, "causal_softmax_fwd",
              softmax.causal_softmax_fwd_plain),
             (softmax, "softmax_bwd", softmax.softmax_bwd_plain),
             (optim, "adam", optim.adam_plain),
             (optim, "sgd", optim.sgd_plain),
             (optim, "adagrad", optim.adagrad_plain),
             (optim, "novograd", optim.novograd_plain),
             (optim, "lamb_stage2", optim.lamb_stage2_plain),
             (scale, "scale", scale.scale_plain),
             (scale, "axpby", scale.axpby_plain),
             (fmha, "flash_fwd", fmha.flash_fwd_plain),
             (fmha, "flash_bwd", fmha.flash_bwd_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------- phase 1

def _ptxas_by_kernel(report):
    """ptxas's -v report summed by kernel template: {name: (fewest and
    most registers of its instances, instances, bytes spilled)}."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Function properties for _ZN?(\w+)", line)
        if m:  # the last of the mangled name's length-prefixed parts
            rest = m.group(1)
            while rest[:1].isdigit():
                n = re.match(r"\d+", rest).group()
                name, rest = (rest[len(n):len(n) + int(n)],
                              rest[len(n) + int(n):])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lo, hi, n, sp = out.get(name, (999, 0, 0, 0))
            r = int(m.group(1))
            out[name] = (min(lo, r), max(hi, r), n + 1, sp + spill)
            name, spill = None, 0
    return out


# kernels whose every instance must build without spills
NO_SPILL = ("scale_vec_kernel", "sgd_vec_kernel", "adagrad_vec_kernel",
            "novograd_norm_kernel", "novograd_update_kernel")


def phase_build():
    from apex_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for line in report.splitlines():
        if line.startswith("== ") or "registers" in line:
            log("  " + line.strip())
    if report:
        by_kernel = _ptxas_by_kernel(report)
        log("ptxas by kernel (registers, instances, bytes spilled): "
            + "; ".join(f"{k} {lo}-{hi}, {n}, {sp}" for k, (lo, hi, n, sp)
                        in sorted(by_kernel.items())))
        for name in NO_SPILL:  # the streaming bodies spill nothing
            assert by_kernel[name][3] == 0, (name, by_kernel[name])
    log(f"build: {len(_build.sources())} sources in {secs:.1f} s "
        f"({'built' if report else 'cached'}) into {_build.BUILD_DIR}")


# ---------------------------------------------------------------- phase 2

def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def entry(name, shape, got, want, tolerance, kernel, plain, library,
          bound_ms_by):
    """One kernel's line: its error against the plain version on the
    same inputs, and the device time of the kernel, the plain version and
    the library call (and the kernel's eager call time, host included).
    ``library`` None: there is no one PyTorch call for the function."""
    return dict(name=name, shape=shape, max_abs_err=max_abs(got, want),
                max_rel_err=max_rel(got, want), tolerance=tolerance,
                ms=device_ms(kernel), call_ms=call_ms(kernel),
                plain_ms=device_ms(plain, iters=5),
                library_ms=None if library is None else device_ms(library),
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1])


def assert_close_scaled(got, want, rtol, scaled_atol=1e-5):
    """Elementwise ``rtol``, with an absolute part of ``scaled_atol``
    times the largest |want| (for outputs that cancel to ~0)."""
    atol = scaled_atol * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def check_rms_norm(gen):
    from apex_tpu_torch.kernels import norm
    h = MODEL["hidden_size"]
    eps = MODEL["layernorm_epsilon"]
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    for rows in (8, BATCH * PROMPT):  # decode step, prefill
        for tin in (torch.float32, torch.bfloat16):
            for tout in (torch.float32, torch.bfloat16):
                x = _randn(gen, rows, h, dtype=tin, scale=3.0)
                got = norm.rms_fwd(x, w, eps, tout)
                want = norm.rms_fwd_plain(x, w, eps, tout)
                torch.cuda.synchronize()
                assert got.dtype == tout and got.shape == x.shape
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=NORM_RTOL, atol=NORM_ATOL)
    # the MLA models' calls: fp32 rows in, bf16 out, at the latent's
    # width 512 (kv_a_norm) and the hidden widths 1024 (mla_decode) and
    # 2048 (deepseek_v2_lite), one row per token of a decode step and of
    # each path's prefill
    for width, rows in ((512, 8), (512, MLA_BATCH * MLA_PREFIX),
                        (512, V2_BATCH * V2_PROMPT), (1024, MLA_BATCH),
                        (1024, MLA_BATCH * MLA_PREFIX), (2048, V2_BATCH),
                        (2048, V2_BATCH * V2_PROMPT)):
        wm = 1.0 + 0.1 * torch.randn(width, generator=gen, device="cuda")
        x = _randn(gen, rows, width, dtype=torch.float32, scale=3.0)
        got = norm.rms_fwd(x, wm, 1e-6, torch.bfloat16)
        want = norm.rms_fwd_plain(x, wm, 1e-6, torch.bfloat16)
        truncated = _toward_zero(norm.rms_fwd)(x, wm, 1e-6, torch.bfloat16)
        torch.cuda.synchronize()
        differ = (got != want).float().mean().item()
        planted = (truncated != want).float().mean().item()
        log(f"kernel rms_norm x[{rows},{width}] fp32->bf16: share of outputs "
            f"that differ from the plain version {differ:.3e} (at most "
            f"{NORM_DIFFER_SHARE}); rounding toward zero planted: "
            f"{planted:.3e}")
        torch.testing.assert_close(got.float(), want.float(), rtol=NORM_RTOL,
                                   atol=NORM_ATOL)
        assert differ <= NORM_DIFFER_SHARE < planted, (rows, width, differ,
                                                       planted)
    # the path's call: bf16 residual stream in, bf16 out
    entries = []
    for rows, label in ((BATCH * PROMPT, "prefill"), (BATCH, "decode")):
        x = _randn(gen, rows, h, scale=3.0)
        got = norm.rms_fwd(x, w, eps, torch.bfloat16)
        want = norm.rms_fwd_plain(x, w, eps, torch.bfloat16)
        w_lib = w.to(x.dtype)  # F.rms_norm takes one dtype
        entries.append(entry(
            "rms_norm", f"{label} x[{rows},{h}] bf16->bf16", got, want,
            f"rtol {NORM_RTOL} atol {NORM_ATOL}",
            lambda: norm.rms_fwd(x, w, eps, torch.bfloat16),
            lambda: norm.rms_fwd_plain(x, w, eps, torch.bfloat16),
            lambda: torch.nn.functional.rms_norm(x, (h,), w_lib, eps),
            bound(rows * h * 2 * 2 + h * 4, 4 * rows * h, FP32_OPS_PER_S)))
    return entries


def _visible(start, w, window):
    """Keys each query position sees, summed over the chunk; and the
    first live cache row."""
    total, lo = 0, start + w
    for i in range(w):
        p = start + i
        first = max(0, p - window + 1) if window else 0
        total += p + 1 - first
        lo = min(lo, first)
    return total, lo


def _attention_work(b, g, rep, d, w, start, window):
    """(bytes, operations) of b rows at one start."""
    keys, lo = _visible(start, w, window)
    live_rows = start + w - lo
    nbytes = (w * b * g * rep * d * 2          # queries, bf16
              + 2 * live_rows * b * g * d * 2  # live K and V rows, bf16
              + w * b * g * rep * d * 4)       # fp32 output
    ops = 4 * d * b * g * rep * keys           # QK^T and PV products
    return nbytes, ops


def _attention_bound(b, g, rep, d, w, start, window):
    return bound(*_attention_work(b, g, rep, d, w, start, window),
                 BF16_TENSOR_OPS_PER_S)


def _attention_bound_rows(starts, g, rep, d, w, window):
    """The bound of rows each at its own start (the engine's slots)."""
    work = [_attention_work(1, g, rep, d, w, int(s), window) for s in starts]
    return bound(sum(x[0] for x in work), sum(x[1] for x in work),
                 BF16_TENSOR_OPS_PER_S)


def _cache(gen, T, b, g, d, filled, dtype=torch.bfloat16):
    """Cache buffers [T, b, g, d] with rows [0, filled) written and the
    rest zero, as the serving path leaves them."""
    k = torch.zeros(T, b, g, d, dtype=dtype, device="cuda")
    v = torch.zeros_like(k)
    k[:filled] = _randn(gen, filled, b, g, d, dtype=dtype)
    v[:filled] = _randn(gen, filled, b, g, d, dtype=dtype)
    return k, v


def check_window_attention(gen):
    from apex_tpu_torch.kernels import fused_cc
    # every option on small shapes, then the path's shape
    for d, dtype in ((64, torch.bfloat16), (128, torch.bfloat16),
                     (64, torch.float32)):
        for T, start, w in ((1000, 0, 37), (1000, 300, 70), (96, 90, 6)):
            for window, cap in ((None, None), (50, None), (None, 30.0),
                                (17, 25.0)):
                q = _randn(gen, w, 2, 3, 4, d, dtype=dtype)
                k, v = _cache(gen, T, 2, 3, d, start + w, dtype)
                got = fused_cc.window_attention(q, k, v, start, d ** -0.5,
                                                window, cap)
                want = fused_cc.window_attention_plain(
                    q, k, v, start, d ** -0.5, window, cap)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=ATTN_TOL,
                                           atol=ATTN_TOL)
    n, g = MODEL["num_attention_heads"], MODEL["num_query_groups"]
    d, rep, T = MODEL["hidden_size"] // n, n // g, MODEL[
        "max_position_embeddings"]
    q = _randn(gen, PROMPT, BATCH, g, rep, d)
    k, v = _cache(gen, T, BATCH, g, d, PROMPT)
    sm = d ** -0.5
    # the path hands the kernel its rows' levels on the device
    start = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    got = fused_cc.window_attention(q, k, v, start, sm)
    want = fused_cc.window_attention_plain(q, k, v, 0, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    # yardstick: SDPA over the live rows, heads-major views of the same
    # tensors (start 0 and w == live rows: plain causal)
    q_l = q.reshape(PROMPT, BATCH, n, d).permute(1, 2, 0, 3)
    k_l = k[:PROMPT].permute(1, 2, 0, 3)
    v_l = v[:PROMPT].permute(1, 2, 0, 3)
    entries = [entry(
        "window_attention",
        f"qg[{PROMPT},{BATCH},{g},{rep},{d}] bf16, cache[{T},{BATCH},{g},"
        f"{d}] bf16, start 0", got, want, f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: fused_cc.window_attention(q, k, v, start, sm),
        lambda: fused_cc.window_attention_plain(q, k, v, start, sm),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q_l, k_l, v_l, is_causal=True, scale=sm, enable_gqa=True),
        _attention_bound(BATCH, g, rep, d, PROMPT, 0, None))]
    del q, k, v, q_l, k_l, v_l, got, want
    # the engine's other shapes: the speculative verify (w 5, 8 slots at
    # mixed levels; SDPA over the whole cache with each row's mask) and
    # the smallest prefill bucket (w 32, b 2, from position 0)
    for w, b, label in ((SPEC_K + 1, BATCH, "verify"), (32, 2, "prefill")):
        starts = (_mixed_offsets(b, T - w + 1, gen) if label == "verify"
                  else torch.zeros(b, dtype=torch.int32, device="cuda"))
        if label == "verify":
            starts[0], starts[-1] = 0, T - w
        live = int(starts.max()) + w
        q = _randn(gen, w, b, g, rep, d)
        k, v = _cache(gen, T, b, g, d, live)
        got = fused_cc.window_attention(q, k, v, starts, sm)
        want = fused_cc.window_attention_plain(q, k, v, starts, sm)
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        q_l = q.reshape(w, b, n, d).permute(1, 2, 0, 3)
        pos = (starts[:, None] + torch.arange(w, device="cuda"))[:, :, None]
        mask = (torch.arange(T, device="cuda")[None, None] <= pos)[:, None]
        k_l, v_l = k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)
        entries.append(entry(
            "window_attention",
            f"{label}: qg[{w},{b},{g},{rep},{d}] bf16, cache[{T},{b},{g},"
            f"{d}] bf16, starts {starts.tolist()}", got, want,
            f"rtol {ATTN_TOL} atol {ATTN_TOL}",
            lambda: fused_cc.window_attention(q, k, v, starts, sm),
            lambda: fused_cc.window_attention_plain(q, k, v, starts, sm),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q_l, k_l, v_l, attn_mask=mask, scale=sm, enable_gqa=True),
            _attention_bound_rows(starts.tolist(), g, rep, d, w, None)))
    return entries


def check_gqa_decode(gen):
    from apex_tpu_torch.contrib import gqa_decode
    for d, dtype in ((64, torch.bfloat16), (128, torch.bfloat16),
                     (64, torch.float32)):
        for g, rep in ((4, 8), (2, 1), (1, 16)):
            for T, length in ((1000, 1), (1000, 777), (96, 96)):
                for window, cap in ((None, None), (50, None), (None, 30.0),
                                    (17, 25.0)):
                    q = _randn(gen, 2, g, rep, d, dtype=dtype)
                    k, v = _cache(gen, T, 2, g, d, length, dtype)
                    got = gqa_decode.gqa_flash_decode(q, k, v, length,
                                                      d ** -0.5, window, cap)
                    want = gqa_decode.gqa_decode_plain(
                        q, k, v, length, d ** -0.5, window, cap)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=ATTN_TOL,
                                               atol=ATTN_TOL)
    n, g = MODEL["num_attention_heads"], MODEL["num_query_groups"]
    d, rep, T = MODEL["hidden_size"] // n, n // g, MODEL[
        "max_position_embeddings"]
    L = DECODE_LENGTH
    q = _randn(gen, BATCH, g, rep, d)
    k, v = _cache(gen, T, BATCH, g, d, L)
    sm = d ** -0.5
    lengths = torch.full((BATCH,), L, dtype=torch.int32, device="cuda")
    got = gqa_decode.gqa_flash_decode(q, k, v, lengths, sm)
    want = gqa_decode.gqa_decode_plain(q, k, v, L, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    q_l = q.reshape(BATCH, n, 1, d)
    k_l = k[:L].permute(1, 2, 0, 3)
    v_l = v[:L].permute(1, 2, 0, 3)
    entries = [entry(
        "gqa_decode",
        f"q[{BATCH},{g},{rep},{d}] bf16, cache[{T},{BATCH},{g},{d}] bf16, "
        f"length {L}", got, want, f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: gqa_decode.gqa_flash_decode(q, k, v, lengths, sm),
        lambda: gqa_decode.gqa_decode_plain(q, k, v, lengths, sm),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q_l, k_l, v_l, scale=sm, enable_gqa=True),
        _attention_bound(BATCH, g, rep, d, 1, L - 1, None))]
    # the engine's other shapes: a full 2048-row slot at b 8, and b 2
    for b, L in ((BATCH, T), (2, DECODE_LENGTH)):
        q = _randn(gen, b, g, rep, d)
        k, v = _cache(gen, T, b, g, d, L)
        lengths = torch.full((b,), L, dtype=torch.int32, device="cuda")
        got = gqa_decode.gqa_flash_decode(q, k, v, lengths, sm)
        want = gqa_decode.gqa_decode_plain(q, k, v, L, sm)
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        q_l = q.reshape(b, n, 1, d)
        k_l, v_l = k[:L].permute(1, 2, 0, 3), v[:L].permute(1, 2, 0, 3)
        entries.append(entry(
            "gqa_decode",
            f"q[{b},{g},{rep},{d}] bf16, cache[{T},{b},{g},{d}] bf16, "
            f"length {L}", got, want, f"rtol {ATTN_TOL} atol {ATTN_TOL}",
            lambda: gqa_decode.gqa_flash_decode(q, k, v, lengths, sm),
            lambda: gqa_decode.gqa_decode_plain(q, k, v, lengths, sm),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q_l, k_l, v_l, scale=sm, enable_gqa=True),
            _attention_bound(b, g, rep, d, 1, L - 1, None)))
    return entries


def _rms_bwd_raw(dy, x, w, eps, path, warps):
    """#7 launched through its C function on ``path`` with ``warps`` warps
    a row (register paths), uncounted: for the first design's time and
    the sweep of warps a row."""
    from apex_tpu_torch.kernels import _checks, norm
    dx = torch.empty_like(x)
    rc = norm._bwd_kernel()(
        dy.data_ptr(), x.data_ptr(), w.data_ptr(), dx.data_ptr(), x.shape[0],
        x.shape[1], float(eps), _checks.DTYPE_CODES[dy.dtype],
        _checks.DTYPE_CODES[x.dtype], path, warps, _checks.stream(x))
    _checks.status("rms_bwd_dx", rc)
    return dx


def _check_rms_bwd_plan(gen, eps):
    """#7 on each branch of its launch plan, every dtype pair of dy and
    x, with and without weight, 37 rows: the register path with 16-byte
    accesses (h 256, 1024 and the limit), with one element an access (h
    1001 and the limit less one; the limit with dy at a 4-byte but not
    16-byte offset), and the block path past the limit (limit + 8)."""
    from apex_tpu_torch.kernels import norm
    names = {norm.LN_BWD_BLOCK: "block", norm.LN_BWD_SCALAR: "scalar",
             norm.LN_BWD_VECTOR: "vector"}
    lim = norm.RMS_BWD_REG_MAX_H
    rows = 37
    taken = []
    for tdy in (torch.float32, torch.bfloat16):
        for tx in (torch.float32, torch.bfloat16):
            dy_size = torch.tensor([], dtype=tdy).element_size()
            x_size = torch.tensor([], dtype=tx).element_size()
            for h, offset, path in ((256, 0, norm.LN_BWD_VECTOR),
                                    (1024, 0, norm.LN_BWD_VECTOR),
                                    (lim, 0, norm.LN_BWD_VECTOR),
                                    (1001, 0, norm.LN_BWD_SCALAR),
                                    (lim - 1, 0, norm.LN_BWD_SCALAR),
                                    (lim + 8, 0, norm.LN_BWD_BLOCK),
                                    (lim, 4, norm.LN_BWD_SCALAR)):
                w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
                x = _randn(gen, rows, h, dtype=tx, scale=3.0)
                flat = _randn(gen, rows * h + 16 // dy_size, dtype=tdy)
                dy = flat[offset // dy_size:][:rows * h].view(rows, h)
                assert dy.data_ptr() % 16 == offset
                p = norm.rms_bwd_plan(h, dy_size, x_size,
                                      dy.data_ptr() % 16 == 0)
                assert p.path == path, (h, offset, tdy, tx, p)
                for weight in (w, None):
                    got = norm.rms_bwd_dx(dy, x, weight, eps)
                    want = norm.rms_bwd_dx_plain(dy, x, weight, eps)
                    torch.cuda.synchronize()
                    assert got.dtype == tx and got.shape == x.shape
                    assert_close_scaled(got, want, NORM_BWD_RTOL[tx])
                if tdy == tx:
                    taken.append(f"{str(tx)[6:]} h {h}"
                                 + (f" dy at +{offset} B" if offset else "")
                                 + f": {names[p.path]}"
                                 + (f", {p.vec} an access, {p.iters} chunks "
                                    f"a lane, {p.warps} warps a row"
                                    if p.iters else ""))
    log("kernels: rms_bwd matches its plain version on each launch plan "
        "branch, every dtype pair, with and without weight ("
        + "; ".join(taken) + ")")


def _rms_bwd_design(gen, h, w, eps):
    """At the flash-off and the flash step's rows ([2048, h] and [4096,
    h], bf16 dy and x), through #7's C function (uncounted): the first
    design (one block a row) and the register path at 2, 4 and 8 warps a
    row, each held to NORM_BWD_RTOL against the plain version, then timed
    in turns (the first design first and last). Returns {rows: {label:
    [us, ...]}}."""
    from apex_tpu_torch.kernels import norm, registry
    before = registry.launches()
    vec = norm.LN_BWD_VECTOR
    out = {}
    for rows in (TRAIN_BATCH * TRAIN_SEQ, FLASH_BATCH * FLASH_SEQ):
        x = _randn(gen, rows, h, scale=3.0)
        dy = _randn(gen, rows, h)
        want = norm.rms_bwd_dx_plain(dy, x, w, eps)
        variants = [("first design", norm.LN_BWD_BLOCK, 0)] + [
            (f"{n} warps a row", vec, n) for n in (2, 4, 8)]
        for label, path, warps in variants:
            assert_close_scaled(_rms_bwd_raw(dy, x, w, eps, path, warps),
                                want, NORM_BWD_RTOL[torch.bfloat16])
        times = {}
        for label, path, warps in variants + variants[::-1]:
            times.setdefault(label, []).append(device_ms(
                lambda: _rms_bwd_raw(dy, x, w, eps, path, warps)) * 1e3)
        out[rows] = times
        plan = norm.rms_bwd_plan(h, 2, 2, True)
        log(f"kernel rms_bwd [{rows},{h}] bf16 through the C function (us, "
            f"in turns; the plan takes {plan.warps} warps a row): "
            + "; ".join(f"{k} {'/'.join(f'{t:.2f}' for t in v)}"
                        for k, v in times.items()))
    assert registry.launches() == before  # the raw launches are uncounted
    return out


def check_rms_bwd(gen):
    from apex_tpu_torch.kernels import norm
    h = MODEL["hidden_size"]
    eps = MODEL["layernorm_epsilon"]
    rows = TRAIN_BATCH * TRAIN_SEQ
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    for n in (8, rows):
        for tx in (torch.float32, torch.bfloat16):
            for tdy in (torch.float32, torch.bfloat16):
                for weight in (w, None):
                    x = _randn(gen, n, h, dtype=tx, scale=3.0)
                    dy = _randn(gen, n, h, dtype=tdy)
                    got = norm.rms_bwd_dx(dy, x, weight, eps)
                    want = norm.rms_bwd_dx_plain(dy, x, weight, eps)
                    torch.cuda.synchronize()
                    assert got.dtype == tx and got.shape == x.shape
                    assert_close_scaled(got, want, NORM_BWD_RTOL[tx])
    _check_rms_bwd_plan(gen, eps)
    design = _rms_bwd_design(gen, h, w, eps)
    # the path's call: dy of the bf16 norm output, the bf16 residual
    x = _randn(gen, rows, h, scale=3.0)
    dy = _randn(gen, rows, h)
    assert norm.rms_bwd_plan(h, 2, 2, True).path == norm.LN_BWD_VECTOR
    got = norm.rms_bwd_dx(dy, x, w, eps)
    want = norm.rms_bwd_dx_plain(dy, x, w, eps)
    assert_close_scaled(got, want, NORM_BWD_RTOL[torch.bfloat16])
    library = None
    if hasattr(torch.ops.aten, "_fused_rms_norm_backward"):
        # the backward op of F.rms_norm (one dtype: a bf16 weight)
        w_lib = w.to(x.dtype)
        _, rstd = torch.ops.aten._fused_rms_norm(x, [h], w_lib, eps)

        def library():
            return torch.ops.aten._fused_rms_norm_backward(
                dy, x, [h], rstd, w_lib, [True, False])
    e = entry(
        "rms_bwd", f"dy, x [{rows},{h}] bf16 -> dx bf16", got, want,
        f"rtol {NORM_BWD_RTOL[torch.bfloat16]} atol 1e-5*max|dx|",
        lambda: norm.rms_bwd_dx(dy, x, w, eps),
        lambda: norm.rms_bwd_dx_plain(dy, x, w, eps), library,
        bound(rows * h * 2 * 3 + h * 4, 10 * rows * h, FP32_OPS_PER_S))
    e["first_design_ms"] = statistics.median(
        design[rows]["first design"]) / 1e3
    if e["library_ms"] is not None:
        log(f"kernel rms_bwd at the path shape: {_us(e['ms'])}, first design "
            f"{_us(e['first_design_ms'])}, _fused_rms_norm_backward "
            f"{_us(e['library_ms'])}: kernel / library "
            f"{e['ms'] / e['library_ms']:.4f}")
    return [e]


def _live_keys(sq, sk):
    """Keys the causal mask leaves live, summed over the sq rows."""
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def _causal_raw(x, scale, path):
    """Kernel #10 on x [B, sq, sk] launched through its C function on
    ``path`` (0 the first design, 1/2 the register path, 3/4 planted
    faults), uncounted."""
    from apex_tpu_torch.kernels import _checks, softmax
    y = torch.empty_like(x)
    rc = softmax._fwd_kernel()(
        x.data_ptr(), y.data_ptr(), x.numel() // x.shape[-1], x.shape[-2],
        x.shape[-1], float(scale), _checks.DTYPE_CODES[x.dtype], path,
        _checks.stream(x))
    _checks.status("causal_softmax", rc)
    return y


# planted #10 faults: (what, path code of apex_causal_softmax_fwd)
CAUSAL_FAULTS = (("the diagonal key dropped", 3),
                 ("the row sum's last butterfly step skipped", 4))


def _softmax_bwd_raw(y, dy, path, dy_ptr=None):
    """#11 on y, dy [..., sk] launched through its C function on ``path``
    (0 the first design, 1/2 the register path, 3/4 planted faults),
    uncounted, dy read from ``dy_ptr`` (default: dy's first element)."""
    from apex_tpu_torch.kernels import _checks, softmax
    dx = torch.empty_like(y)
    rc = softmax._bwd_kernel()(
        y.data_ptr(), dy.data_ptr() if dy_ptr is None else dy_ptr,
        dx.data_ptr(), y.numel() // y.shape[-1], y.shape[-1], 1.0,
        _checks.DTYPE_CODES[y.dtype], path, _checks.stream(y))
    _checks.status("softmax_bwd", rc)
    return dx


def _softmax_bwd_design(y, dy, path):
    """#11's first design (one block a row) and the register ``path``
    timed through the C function in turns, first design first; returns
    {path: [device ms, ...]}."""
    from apex_tpu_torch.kernels import softmax
    names = {softmax.BLOCK: "block", softmax.SCALAR: "scalar",
             softmax.VECTOR: "vector"}
    design = {}
    for p in (softmax.BLOCK, path, path, softmax.BLOCK):
        design.setdefault(p, []).append(device_ms(
            lambda: _softmax_bwd_raw(y, dy, p)))
    log(f"kernel softmax_bwd at {list(y.shape)} {str(y.dtype)[6:]} through "
        f"the C function (us, the first design's block path, then the "
        f"register path, in turns): " + "; ".join(
            f"{names[p]} " + "/".join(f"{t * 1e3:.2f}" for t in ts)
            for p, ts in design.items()))
    return design


def _softmax_bwd_sweep(gen):
    """#11's first design beside its register path through the C
    function, in turns, at 64 M fp32 elements in rows of 256, 512 and 768
    keys (1024: the causal path shape): the measurement behind
    BWD_REG_MAX_KEYS."""
    from apex_tpu_torch.kernels import softmax
    for sk in (256, 512, 768):
        rows = (64 << 20) // sk
        y = torch.softmax(torch.randn(rows, sk, generator=gen,
                                      device="cuda") * 4, -1)
        dy = torch.randn(rows, sk, generator=gen, device="cuda")
        _softmax_bwd_design(y, dy, softmax.VECTOR)


# planted #11 faults: (what, path code of apex_softmax_bwd)
SOFTMAX_BWD_FAULTS = (("the butterfly's last step skipped", 3),
                      ("dy read one key ahead", 4))


def _softmax_bwd_faults_and_design(y, dy, ref):
    """At BERT's shape, through #11's C function (uncounted): the
    register path and the first design, and two planted faults in the
    register path (SOFTMAX_BWD_FAULTS; dy copied into a buffer one vector
    longer for the read ahead), held to SOFTMAX_BWD_RTOL against the
    plain version (the faults must read past it); then the first design
    timed beside the register path, in turns. Returns the first design's
    median device ms."""
    from apex_tpu_torch.kernels import registry, softmax
    before = registry.launches()
    tol = (SOFTMAX_BWD_RTOL[y.dtype], 1e-5 * ref.float().abs().max().item())
    padded = torch.cat([dy.reshape(-1), dy.new_zeros(16)])
    readings = {"honest": _softmax_bwd_raw(y, dy, softmax.VECTOR),
                "first design": _softmax_bwd_raw(y, dy, softmax.BLOCK)}
    for what, path in SOFTMAX_BWD_FAULTS:
        readings[what] = _softmax_bwd_raw(y, padded, path)
    readings = {k: (_tol_ratio(v, ref, *tol), max_abs(v, ref))
                for k, v in readings.items()}
    log("kernel softmax_bwd at the path shape: "
        + "; ".join(f"{k}: {r:.3e} of the tolerance (max abs err {e:.3e})"
                    for k, (r, e) in readings.items()))
    honest = ("honest", "first design")
    assert all(readings[k][0] <= 1.0 for k in honest), readings
    assert all(r > 1.0 for k, (r, _) in readings.items() if k not in honest), \
        readings
    design = _softmax_bwd_design(y, dy, softmax.VECTOR)
    assert registry.launches() == before  # the raw launches are uncounted
    return statistics.median(design[softmax.BLOCK])


def _check_softmax_bwd_plan(gen):
    """#11 on each branch of its launch plan (the forwards' ``plan`` up to
    BWD_REG_MAX_KEYS), fp32 and bf16, 2 x 3 x 5 rows (a warp's last group
    of rows may hold none): 16-byte register rows (32, 128 and 768 keys),
    one key an access (357 keys; 128 with y, or dy, at a 4-byte but not
    16-byte offset), the block path past BWD_REG_MAX_KEYS (776 and 1025
    keys); scales 1 and 0.125. In every case row 1 holds y = 0 on its
    second half and dy = inf on its last key: 0 * inf makes that row NaN,
    as in JAX, on both sides."""
    from apex_tpu_torch.kernels import softmax
    names = {softmax.BLOCK: "block", softmax.SCALAR: "scalar",
             softmax.VECTOR: "vector"}
    reg = softmax.BWD_REG_MAX_KEYS
    taken = []
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        for sk, which, offset, path in ((32, "y", 0, softmax.VECTOR),
                                        (128, "y", 0, softmax.VECTOR),
                                        (357, "y", 0, softmax.SCALAR),
                                        (reg, "y", 0, softmax.VECTOR),
                                        (reg + 8, "y", 0, softmax.BLOCK),
                                        (softmax.REG_MAX_KEYS + 1, "y", 0,
                                         softmax.BLOCK),
                                        (128, "y", 4, softmax.SCALAR),
                                        (128, "dy", 4, softmax.SCALAR)):
            shape = (2, 3, 5, sk)
            n = 2 * 3 * 5 * sk
            views = {}
            for name in ("y", "dy"):
                off = offset if name == which else 0
                flat = _randn(gen, n + 16 // size, dtype=torch.float32,
                              scale=4.0)
                if name == "y":
                    flat = torch.softmax(flat[:n].view(shape), -1).reshape(
                        -1).to(dtype)
                    flat = torch.cat([flat, flat.new_zeros(16 // size)])
                else:
                    flat = flat.to(dtype)
                views[name] = flat[off // size:][:n].view(shape)
                assert views[name].data_ptr() % 16 == off
            y, dy = views["y"], views["dy"]
            y[0, 0, 1, sk // 2:] = 0.0
            dy[0, 0, 1, -1] = float("inf")
            p = softmax.plan(sk, size, y.data_ptr() % 16 == 0
                             and dy.data_ptr() % 16 == 0, reg)
            assert p.path == path, (sk, which, offset, dtype, p)
            for scale in (1.0, 0.125):
                got = softmax.softmax_bwd(y, dy, scale)
                want = softmax.softmax_bwd_plain(y, dy, scale)
                torch.cuda.synchronize()
                assert got.dtype == dtype and got.shape == y.shape
                nan = torch.isnan(want).any(-1)
                assert nan[0, 0, 1] and nan.sum() == 1, nan.nonzero()
                assert torch.isnan(got[0, 0, 1]).all(), \
                    "0 * inf does not make the row NaN"
                assert_close_scaled(got[~nan], want[~nan],
                                    SOFTMAX_BWD_RTOL[dtype])
            taken.append(f"{str(dtype)[6:]} sk {sk}"
                         + (f" {which} at +{offset} B" if offset else "")
                         + f": {names[p.path]}, {p.lanes} lanes a row")
    log("kernels: softmax_bwd matches its plain version on each launch plan "
        "branch, a row with dy inf where y is 0 NaN on both sides ("
        + "; ".join(taken) + ")")


def _check_causal_case(x, scale):
    """#10 on x against its plain version: rows with no live key (sq >
    sk) and rows whose live scores all lie far below -10000 are NaN on
    both sides, NaN for NaN; dead keys of every other row exactly 0."""
    from apex_tpu_torch.kernels import softmax
    got = softmax.causal_softmax_fwd(x, scale)
    want = softmax.causal_softmax_fwd_plain(x, scale)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    sq, sk = x.shape[-2:]
    live = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(sk - sq)
    nan_rows = torch.isnan(want).any(-1, keepdim=True)
    assert torch.equal(torch.isnan(got), torch.isnan(want)), \
        "NaN rows differ from the plain version's"
    assert (got[~live & ~nan_rows] == 0).all(), "a masked key is not 0"
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=SOFTMAX_RTOL[x.dtype], atol=SOFTMAX_ATOL,
                               equal_nan=True)
    return want


def check_softmax(gen):
    """The causal softmax forward #10 and the softmax backward #11: off
    the path (fp32 and bf16, scales 1 and 0.125, sq = sk, sq < sk and sq >
    sk with rows of no live key, a row whose live scores lie below
    -10000), each branch of the launch plan (16-byte register rows, rows
    sharing a warp, one key an access at sk 357 and at a 4-byte offset,
    the block path past REG_MAX_KEYS), then the training step's [64,
    1024, 1024] fp32 scores: two planted faults through the kernel's own
    launch, the first design timed beside the register path in turns,
    and the backward at the same shape."""
    from apex_tpu_torch.kernels import registry, softmax
    names = {softmax.BLOCK: "block", softmax.SCALAR: "scalar",
             softmax.VECTOR: "vector"}
    taken = []
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        for b, sq, sk, offset in ((4, 128, 128, 0), (3, 100, 357, 0),
                                  (5, 33, 1000, 0), (2, 40, 32, 0),
                                  (3, 9, 8, 0), (2, 16, 4, 0),
                                  (2, 64, 1024, 0), (2, 5, 1025, 0),
                                  (2, 7, softmax.MAX_KEYS, 0),
                                  (3, 50, 128, 4)):
            n = b * sq * sk
            flat = _randn(gen, n + 16 // size, dtype=dtype, scale=4.0)
            x = flat[offset // size:][:n].view(b, sq, sk)
            assert x.data_ptr() % 16 == offset
            # row 1 of batch 0: live scores far below -10000 (a max of
            # -10000, every exp 0: NaN); row 2 just below (a tiny sum)
            x[0, 1] = -20000.0
            x[0, 2] = -10048.0
            plan = softmax.plan(sk, size, offset == 0)
            for scale in (1.0, 0.125):
                want = _check_causal_case(x, scale)
                y = want.clone()
                y[torch.isnan(y)] = 0.0
                dy = _randn(gen, b, sq, sk, dtype=dtype)
                got = softmax.softmax_bwd(y, dy, scale)
                ref = softmax.softmax_bwd_plain(y, dy, scale)
                torch.cuda.synchronize()
                assert got.dtype == dtype
                assert_close_scaled(got, ref, SOFTMAX_BWD_RTOL[dtype])
            taken.append(f"{str(dtype)[6:]} [{b},{sq},{sk}]"
                         + (f" at +{offset} B" if offset else "")
                         + f": {names[plan.path]}, {plan.lanes} lanes a row")
    log("kernels: causal_softmax and softmax_bwd match their plain versions "
        "off the path, NaN rows (no live key; live scores below -10000) "
        "NaN for NaN, dead keys exactly 0 (" + "; ".join(taken) + ")")
    _check_softmax_bwd_plan(gen)
    # the path: [b * heads, s, s] fp32 scores, scale 1
    B = TRAIN_BATCH * MODEL["num_attention_heads"]
    S = TRAIN_SEQ
    assert softmax.plan(S, 4, True).path == softmax.VECTOR
    x = _randn(gen, B, S, S, dtype=torch.float32, scale=4.0)
    got = softmax.causal_softmax_fwd(x, 1.0)
    want = softmax.causal_softmax_fwd_plain(x, 1.0)
    torch.testing.assert_close(got, want, rtol=SOFTMAX_RTOL[torch.float32],
                               atol=SOFTMAX_ATOL)
    live = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    assert (got[:, ~live] == 0).all(), "a masked key is not 0"
    # planted faults through the kernel's own launch (uncounted)
    tol = (SOFTMAX_RTOL[torch.float32], SOFTMAX_ATOL)
    before = registry.launches()
    readings = {"honest": _causal_raw(x, 1.0, softmax.VECTOR)}
    for what, path in CAUSAL_FAULTS:
        readings[what] = _causal_raw(x, 1.0, path)
    # rows 64 on: a fault's reading where its output stays finite (row 0
    # with its diagonal dropped has no live key, and a lane pair whose
    # odd lane holds no live key sums 0 without the last step: NaN)
    readings = {k: (_tol_ratio(v, want, *tol), max_abs(v, want),
                    _tol_ratio(v[:, 64:], want[:, 64:], *tol))
                for k, v in readings.items()}
    log("kernel causal_softmax at the path shape: "
        + "; ".join(f"{k}: {r:.3e} of the tolerance, {r64:.3e} from row 64 "
                    f"on (max abs err {e:.3e})"
                    for k, (r, e, r64) in readings.items()))
    assert readings["honest"][0] <= 1.0, readings
    assert all(r > 1.0 and r64 > 1.0 for k, (r, _, r64) in readings.items()
               if k != "honest"), readings
    # the first design (one block a row) beside the register path, both
    # through the C function, in turns
    design = {}
    for path in (softmax.BLOCK, softmax.VECTOR, softmax.VECTOR,
                 softmax.BLOCK):
        design.setdefault(path, []).append(device_ms(
            lambda: _causal_raw(x, 1.0, path)))
    assert registry.launches() == before  # the raw launches are uncounted
    x_masked = x.masked_fill(~live, float("-inf"))
    keys = _live_keys(S, S)
    fwd = entry(
        "causal_softmax", f"x [{B},{S},{S}] fp32, scale 1", got, want,
        f"rtol {SOFTMAX_RTOL[torch.float32]} atol {SOFTMAX_ATOL}",
        lambda: softmax.causal_softmax_fwd(x, 1.0),
        lambda: softmax.causal_softmax_fwd_plain(x, 1.0),
        lambda: torch.softmax(x_masked, dim=-1),  # the mask applied before
        bound(B * keys * 4 + B * S * S * 4, 5 * B * keys, FP32_OPS_PER_S))
    fwd["first_design_ms"] = statistics.median(design[softmax.BLOCK])
    fwd["library"] = "torch.softmax, the mask applied before"
    log("kernel causal_softmax at the path shape through the C function "
        "(us, the first design's block path, then the register path, in "
        "turns): block "
        + "/".join(f"{t * 1e3:.2f}" for t in design[softmax.BLOCK])
        + "; vector "
        + "/".join(f"{t * 1e3:.2f}" for t in design[softmax.VECTOR])
        + f"; the "
        f"wrapper {_us(fwd['ms'])}: first design / wrapper "
        f"{fwd['first_design_ms'] / fwd['ms']:.4f}, wrapper / torch.softmax "
        f"{fwd['ms'] / fwd['library_ms']:.4f}")
    y = want
    dy = _randn(gen, B, S, S, dtype=torch.float32)
    got = softmax.softmax_bwd(y, dy, 1.0)
    ref = softmax.softmax_bwd_plain(y, dy, 1.0)
    assert_close_scaled(got, ref, SOFTMAX_BWD_RTOL[torch.float32])
    # the plan keeps the first design past BWD_REG_MAX_KEYS; the register
    # path, held to the same tolerance, timed beside it in turns here and
    # at shorter rows
    path = softmax.plan(S, 4, True, softmax.BWD_REG_MAX_KEYS).path
    assert path == softmax.BLOCK
    before = registry.launches()
    tol = (SOFTMAX_BWD_RTOL[torch.float32],
           1e-5 * ref.float().abs().max().item())
    held = _tol_ratio(_softmax_bwd_raw(y, dy, softmax.VECTOR), ref, *tol)
    log(f"kernel softmax_bwd at the causal path shape, the register path "
        f"through the C function: {held:.3e} of the tolerance")
    assert held <= 1.0, held
    design = _softmax_bwd_design(y, dy, softmax.VECTOR)
    _softmax_bwd_sweep(gen)
    assert registry.launches() == before  # the raw launches are uncounted
    bwd = entry(
        "softmax_bwd", f"y, dy [{B},{S},{S}] fp32, scale 1", got, ref,
        f"rtol {SOFTMAX_BWD_RTOL[torch.float32]} atol 1e-5*max|dx|",
        lambda: softmax.softmax_bwd(y, dy, 1.0),
        lambda: softmax.softmax_bwd_plain(y, dy, 1.0),
        lambda: torch._softmax_backward_data(dy, y, -1, torch.float32),
        bound(3 * B * S * S * 4, 5 * B * S * S, FP32_OPS_PER_S))
    bwd["first_design_ms"] = statistics.median(design[softmax.BLOCK])
    bwd["register_path_ms"] = statistics.median(design[softmax.VECTOR])
    bwd["library"] = "torch._softmax_backward_data"
    log(f"kernel softmax_bwd at the causal path shape ({names[path]} "
        f"planned): the wrapper {_us(bwd['ms'])}, register path / first "
        f"design {bwd['register_path_ms'] / bwd['first_design_ms']:.4f} "
        f"through the C function, wrapper / _softmax_backward_data "
        f"{bwd['ms'] / bwd['library_ms']:.4f}")
    return [fwd, bwd]


def _live_pairs(s, causal, window):
    """(query, key) pairs the mask leaves visible in one head."""
    if not causal:
        return s * s
    return sum(min(i + 1, window or s) for i in range(s))


def _flash_inputs(gen, b, n, s, d, dtype, alibi):
    q, k, v, do = (_randn(gen, b, n, s, d, dtype=dtype) for _ in range(4))
    slopes = (torch.rand(n, generator=gen, device="cuda") * 0.2 if alibi
              else None)
    return q, k, v, do, slopes


def _flash_close(got, want, dtype):
    """Hold a flash output to its plain version within FLASH_TOL; returns
    the reading as a share of the tolerance."""
    rtol, scaled_atol = FLASH_TOL[dtype]
    atol = scaled_atol * want.float().abs().max().item()
    reading = _tol_ratio(got, want, rtol, atol)
    assert reading <= 1.0, (reading, rtol, atol, max_abs(got, want))
    return reading


def _flash_w1_close(q, k, v, do, scale, dq, dk):
    """The window-1 case's dq and dk held to the true answer (softmax
    attention's gradients by autograd in float64) within FLASH_W1_ULPS of
    the scale of the sums behind ds (see FLASH_W1_ULPS); returns the
    readings as shares of that tolerance."""
    from apex_tpu_torch.contrib import fmha
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    sc = torch.matmul(q64, k64.transpose(-1, -2)) * scale
    live = fmha._visible(sc.shape[-2], sc.shape[-1], True, 1, sc.device)
    o = torch.matmul(torch.softmax(sc.masked_fill(~live, float("-inf")),
                                   -1), v64)
    dq64, dk64 = torch.autograd.grad(o, (q64, k64), do.double())
    sums = (do.double() * v.double()).abs().sum(-1, keepdim=True)
    ulps = FLASH_W1_ULPS * 2.0 ** -23 * scale * sums
    rtol = FLASH_TOL[torch.float32][0]
    readings = {}
    for name, got, want, other in (("dq", dq, dq64, k), ("dk", dk, dk64, q)):
        err = (got.double() - want).abs()
        tol = ulps * other.double().abs() + rtol * want.abs()
        reading = torch.where(err == 0, 0.0, err / tol).max().item()
        assert reading <= 1.0, (name, reading, err.max().item())
        readings[name] = reading
    return readings


def _flash_fwd_raw(args, path):
    """o and lse through the forward's C function on ``path``
    (fmha.PATH_SIMT, fmha.PATH_MMA or a FLASH_FAULTS code), uncounted: for
    the first design's time and the planted faults."""
    from apex_tpu_torch.contrib import fmha
    from apex_tpu_torch.kernels import _checks
    q, k, v, _, _, _, scale, causal, window, slopes = args
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    tail, slopes_ptr = fmha._common(q, scale, causal, window, slopes,
                                    _checks.DTYPE_CODES[q.dtype], path)
    rc = fmha._kernel("apex_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes_ptr, o.data_ptr(),
        lse.data_ptr(), *tail)
    _checks.status("flash_fwd", rc)
    return o, lse


def _flash_bwd_raw(kind, args, path):
    """dq (kind "dq") or dk and dv concatenated ("dkv") through the C
    function on ``path`` (fmha.PATH_SIMT, fmha.PATH_MMA or a FLASH_FAULTS
    code), uncounted: for the first design's time and the planted
    faults."""
    from apex_tpu_torch.contrib import fmha
    from apex_tpu_torch.kernels import _checks
    q, k, v, do, lse, delta, scale, causal, window, slopes = args
    outs = [torch.empty_like(q) for _ in range(1 if kind == "dq" else 2)]
    tail, slopes_ptr = fmha._common(q, scale, causal, window, slopes,
                                    _checks.DTYPE_CODES[q.dtype], path)
    rc = fmha._kernel(f"apex_flash_{kind}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), slopes_ptr,
        *(t.data_ptr() for t in outs), *tail)
    _checks.status(f"flash_{kind}", rc)
    return outs[0] if kind == "dq" else torch.cat(outs)


def _flash_check(q, k, v, do, slopes, causal, window, body, fwd_body,
                 scale=None):
    """Each flash kernel against its plain version on the same inputs:
    the forward's o and lse on the forward body ``fwd_body``, then dq and
    dk/dv from the kernel's o and lse (so the backward is held alone), on
    the backward body ``body`` (fmha.PATH_*; the wrappers' choices for
    these tensors are asserted to be them), each run twice: the two runs
    must be bit-identical. ``scale`` defaults to 1/sqrt(d). Returns the
    results and the readings (shares of the tolerance)."""
    from apex_tpu_torch.contrib import fmha
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    fwd_path = fmha.fwd_plan(q.shape[-1], q.dtype,
                             fmha._aligned(q, k, v)).path
    assert fwd_path == fwd_body, (fwd_path, fwd_body)
    o, lse = fmha.flash_fwd(q, k, v, scale, causal, window, slopes)
    o2, lse2 = fmha.flash_fwd(q, k, v, scale, causal, window, slopes)
    o_p, lse_p = fmha.flash_fwd_plain(q, k, v, scale, causal, window, slopes)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        "two forward runs differ"
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    fwd_reading = _flash_close(o, o_p, q.dtype)
    torch.testing.assert_close(lse, lse_p, rtol=FLASH_LSE_RTOL,
                               atol=FLASH_LSE_RTOL)
    delta = fmha._delta(o, do)
    args = (q, k, v, do, lse, delta, scale, causal, window, slopes)
    path = fmha._bwd_path(q, k, v, do)
    assert path == body, (path, body)
    dq = fmha.flash_dq(*args)
    dk, dv = fmha.flash_dkv(*args)
    dq2 = fmha.flash_dq(*args)
    dk2, dv2 = fmha.flash_dkv(*args)
    dq_p = fmha.flash_dq_plain(*args)
    dk_p, dv_p = fmha.flash_dkv_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2), "two backward runs differ"
    assert all(t.dtype == q.dtype for t in (dq, dk, dv))
    window_1 = causal and window == 1
    if window_1:  # dq and dk: see FLASH_W1_ULPS
        assert q.dtype == torch.float32 and slopes is None
        readings = _flash_w1_close(q, k, v, do, scale, dq, dk)
    else:
        readings = {"dq": _flash_close(dq, dq_p, q.dtype),
                    "dk": _flash_close(dk, dk_p, q.dtype)}
    readings = {"o": fwd_reading, **readings,
                "dv": _flash_close(dv, dv_p, q.dtype)}
    return dict(o=(o, o_p), lse=(lse, lse_p), dq=(dq, dq_p),
                dkv=(torch.cat([dk, dv]), torch.cat([dk_p, dv_p])),
                args=args, path=path, readings=readings,
                w1=window_1)


def _flash_bounds(d, pairs, dtype):
    """((fwd, dq, dkv) operations, their peak rate) for the least time the
    card takes for the products at fp32 accuracy, ``pairs`` live pairs,
    each product 2d operations a pair: fwd q.k^T and p.v; dq q.k^T,
    do.v^T and ds.k; dk/dv q.k^T, do.v^T, p^T.do and ds^T.q. p and ds are
    fp32 whatever the inputs. fp32 x fp32 takes three TF32 products at
    495 TFLOP/s (cheaper than six bf16 ones at 989): 3 x (2, 3, 4). With
    bf16 inputs, bf16 x bf16 is one bf16 product at 989, and p or ds
    against a bf16 operand three bf16 terms at 989 (cheaper than two
    TF32 ones at 495): 1 + 3, 1 + 1 + 3 and 1 + 1 + 3 + 3."""
    if dtype == torch.float32:
        return (tuple(2 * TF32_SPLIT_TERMS * n * d * pairs
                      for n in (2, 3, 4)), TF32_TENSOR_OPS_PER_S)
    return (tuple(2 * n * d * pairs for n in (4, 5, 8)),
            BF16_TENSOR_OPS_PER_S)


# the planted faults of the forward and the backward: csrc/flash_attention.cu's
# path codes kFaultNoLo and kFaultSkipLast (fp32, head dim 64), which no
# caller of the package passes
FLASH_FAULTS = (("lo terms dropped", 2),
                ("last tile of each causal range skipped", 3))


def _flash_faults_and_design(r, dtype):
    """At the path shape, through the C functions (uncounted): the honest
    tensor-core launch and two planted faults (the lo terms dropped; the
    last key tile of each forward and dq range and the last query tile of
    each dk/dv range skipped), held to FLASH_TOL against the plain
    versions (the faults must read past it); then the first design timed
    beside the tensor-core body, in turns. Returns {kind: {path: [us,
    ...]}} for kinds fwd, dq and dkv."""
    from apex_tpu_torch.contrib import fmha
    from apex_tpu_torch.kernels import registry
    before = registry.launches()
    args = r["args"]
    rtol, share = FLASH_TOL[dtype]
    raw = {"fwd": lambda path: _flash_fwd_raw(args, path)[0],
           "dq": lambda path: _flash_bwd_raw("dq", args, path),
           "dkv": lambda path: _flash_bwd_raw("dkv", args, path)}
    if dtype == torch.float32:
        for kind, run in raw.items():
            want = r["o" if kind == "fwd" else kind][1]
            atol = share * want.float().abs().max().item()
            readings = {label: _tol_ratio(run(path), want, rtol, atol)
                        for label, path in (("honest", fmha.PATH_MMA),
                                            *FLASH_FAULTS)}
            log(f"kernel flash_{kind} at the path shape (fp32), share of "
                f"FLASH_TOL: " + "; ".join(f"{k}: {v:.3e}"
                                          for k, v in readings.items()))
            assert readings["honest"] <= 1.0, readings
            assert all(v > 1.0 for k, v in readings.items()
                       if k != "honest"), readings
    design = {kind: {} for kind in raw}
    for path in (fmha.PATH_SIMT, fmha.PATH_MMA, fmha.PATH_MMA,
                 fmha.PATH_SIMT):
        for kind, run in raw.items():
            design[kind].setdefault(path, []).append(device_ms(
                lambda: run(path)) * 1e3)
    assert registry.launches() == before  # the raw launches are uncounted
    log(f"kernel flash at the path shape ({str(dtype)[6:]}) through the C "
        f"functions (us, the first design, then the tensor-core body, in "
        f"turns): " + "; ".join(
            f"{kind} first design "
            f"{'/'.join(f'{t:.2f}' for t in design[kind][fmha.PATH_SIMT])}, "
            f"tensor cores "
            f"{'/'.join(f'{t:.2f}' for t in design[kind][fmha.PATH_MMA])}"
            for kind in raw))
    return design


def _at_plus4(t):
    """A contiguous copy of fp32 ``t`` starting 4 bytes past a 16-byte
    boundary (the wrappers then take the first design)."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape).copy_(t)
    assert t.dtype == torch.float32 and out.is_contiguous() \
        and out.data_ptr() % 16 == 4
    return out


def _flash_mha_entry(gen):
    """#1 at the MHA phase's call: SelfMultiheadAttn hands it bf16 q, k and
    v [MHA_BATCH, MHA_HEADS, MHA_SEQ, 64], not causal: the kernel against
    its plain version, and its time beside the first design's, the plain
    version's and SDPA's, in one run."""
    from apex_tpu_torch.contrib import fmha
    n, d = MHA_HEADS, MHA_HIDDEN // MHA_HEADS
    B, S, bf16 = MHA_BATCH, MHA_SEQ, torch.bfloat16
    q, k, v, _, _ = _flash_inputs(gen, B, n, S, d, bf16, False)
    scale = d ** -0.5
    assert fmha.fwd_plan(d, bf16, fmha._aligned(q, k, v)).path == \
        fmha.PATH_MMA
    o, _ = fmha.flash_fwd(q, k, v, scale, False)
    o_p, _ = fmha.flash_fwd_plain(q, k, v, scale, False)
    _flash_close(o, o_p, bf16)
    ops, peak = _flash_bounds(d, B * n * S * S, bf16)
    e = entry(
        "flash_fwd", f"q,k,v [{B},{n},{S},{d}] bf16, not causal (the MHA "
        f"phase's call)", o, o_p,
        f"rtol {FLASH_TOL[bf16][0]} atol {FLASH_TOL[bf16][1]}*max|want|",
        lambda: fmha.flash_fwd(q, k, v, scale, False),
        lambda: fmha.flash_fwd_plain(q, k, v, scale, False),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale),
        bound(4 * B * n * S * d * 2 + B * n * S * 4, ops[0], peak))
    args = (q, k, v, None, None, None, scale, False, None, None)
    e["first_design_ms"] = device_ms(
        lambda: _flash_fwd_raw(args, fmha.PATH_SIMT))
    e["library"] = "SDPA forward"
    return e


def check_flash(gen):
    from apex_tpu_torch.contrib import fmha
    mma, simt = fmha.PATH_MMA, fmha.PATH_SIMT
    names = {mma: "tensor cores", simt: "first design"}
    # off the path: (b, n, s, d, dtype, causal, window, alibi, scale); s =
    # 200, 300 and 77 leave a ragged last tile, b*n = 1 a single head;
    # scale None is 1/sqrt(d) (a power of two at d 64, where bf16 q * scale
    # is one bf16 term; 0.1 and d 128's are not: three terms)
    f32, bf16 = torch.float32, torch.bfloat16
    taken = []
    for b, n, s, d, dtype, causal, window, alibi, scale in (
            (1, 1, 200, 64, f32, True, None, False, None),
            (2, 2, 256, 64, f32, False, None, False, None),
            (1, 2, 200, 64, f32, False, None, False, 0.3),
            (1, 2, 256, 64, f32, True, 1, False, None),
            (1, 2, 300, 64, bf16, True, 37, True, None),
            (1, 2, 300, 64, bf16, True, 37, True, 0.1),
            (2, 3, 77, 64, bf16, False, None, False, None),
            (1, 2, 512, 64, f32, True, 256, False, None),
            (1, 2, 256, 64, f32, True, None, True, None),
            (2, 2, 256, 64, bf16, False, None, True, None),
            (1, 2, 200, 128, f32, True, 37, False, None),
            (1, 2, 256, 128, bf16, False, None, True, None),
            (1, 2, 77, 128, bf16, True, None, False, None),
            (1, 2, 200, 256, f32, True, None, False, None),
            (1, 2, 128, 256, bf16, False, None, False, None),
            (1, 3, 77, 256, f32, True, 256, True, None)):
        q, k, v, do, slopes = _flash_inputs(gen, b, n, s, d, dtype, alibi)
        body = mma if d <= 128 else simt
        # (label, q, do, backward body, forward body)
        cases = [("", q, do, body, body)]
        if (s, d, dtype, window, scale) == (200, 64, f32, None, None):
            # the same inputs with do, then q, 4 bytes past a 16-byte
            # boundary: the wrappers take the first design there
            cases += [(", do at +4 bytes", q, _at_plus4(do), simt, mma),
                      (", q at +4 bytes", _at_plus4(q), do, simt, simt)]
        for label, q_, do_, bwd, fwd in cases:
            r = _flash_check(q_, k, v, do_, slopes, causal, window, bwd, fwd,
                             scale)
            taken.append(
                f"s {s} d {d} {str(dtype)[6:]} "
                f"{'causal' if causal else 'full'} w {window}"
                f"{' alibi' if alibi else ''}"
                f"{f' scale {scale}' if scale else ''}{label}: forward "
                f"{names[fwd]}, backward {names[bwd]}"
                f"{' (dq, dk: float64 truth, FLASH_W1_ULPS)' if r['w1'] else ''}"
                f", " + " ".join(f"{k} {x:.2e}"
                                 for k, x in r["readings"].items()))
    log("kernels: flash fwd, dq and dk/dv match their plain versions off "
        "the path (full, windows 1/37/256, ALiBi, head dims 128 and 256, "
        "fp32 and bf16, scales off a power of two, ragged tails, one head, "
        "a misaligned do and q); bodies and readings as shares of the "
        "tolerance, two runs bit-identical: " + "; ".join(taken))

    # the path: the flash training step's q/k/v, [2, 32, 2048, 64], causal,
    # fp32 (the QKV bias add leaves them fp32, as in JAX); and the same
    # shape in bf16
    n, d = MODEL["num_attention_heads"], MODEL["hidden_size"] // MODEL[
        "num_attention_heads"]
    B, S = FLASH_BATCH, FLASH_SEQ
    pairs = B * n * _live_pairs(S, True, None)
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        fma_peak = FP32_OPS_PER_S if dtype == torch.float32 else (
            BF16_TENSOR_OPS_PER_S)
        q, k, v, do, _ = _flash_inputs(gen, B, n, S, d, dtype, False)
        r = _flash_check(q, k, v, do, None, True, None, mma, mma)
        scale = d ** -0.5
        args = r["args"]
        shape = f"q,k,v [{B},{n},{S},{d}] {str(dtype)[6:]}, causal"
        tol = (f"rtol {FLASH_TOL[dtype][0]} atol "
               f"{FLASH_TOL[dtype][1]}*max|want|")
        design = _flash_faults_and_design(r, dtype)
        # yardsticks, never called by the port: SDPA, and SDPA's backward
        # (fwd+bwd minus fwd) as the dq+dk+dv time on both backward rows
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, scale=scale)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (ql, kl, vl), do)

        sdpa_fwd_ms = call_ms(lambda: sdpa().detach(), 50, 3)
        sdpa_bwd_ms = call_ms(sdpa_fwd_bwd, 50, 3) - sdpa_fwd_ms
        profile_window(f"SDPA forward and backward ({str(dtype)[6:]}), "
                       f"the yardstick", sdpa_fwd_bwd, top=4)
        bnsd, bns = B * n * S * d * es, B * n * S * 4
        # the bound at fp32 accuracy on the tensor cores; earlier_bound_ms
        # keeps the one the table gave before (fp32: FMAs at 67 TFLOP/s;
        # bf16: one product at the bf16 tensor cores' 989)
        ops, peak = _flash_bounds(d, pairs, dtype)
        fwd = entry(
            "flash_fwd", shape, *r["o"], tol,
            lambda: fmha.flash_fwd(q, k, v, scale, True),
            lambda: fmha.flash_fwd_plain(q, k, v, scale, True), None,
            bound(4 * bnsd + bns, ops[0], peak))
        fwd["library_ms"] = sdpa_fwd_ms
        fwd["lse_max_abs_err"] = max_abs(*r["lse"])
        fwd["earlier_bound_ms"] = bound(4 * bnsd + bns, 4 * d * pairs,
                                    fma_peak)[0]
        dq = entry(
            "flash_dq", shape, *r["dq"], tol,
            lambda: fmha.flash_dq(*args), lambda: fmha.flash_dq_plain(*args),
            None, bound(5 * bnsd + 2 * bns, ops[1], peak))
        dq["earlier_bound_ms"] = bound(5 * bnsd + 2 * bns, 6 * d * pairs,
                                   fma_peak)[0]
        dkv = entry(
            "flash_dkv", shape, *r["dkv"], tol,
            lambda: fmha.flash_dkv(*args),
            lambda: fmha.flash_dkv_plain(*args), None,
            bound(6 * bnsd + 2 * bns, ops[2], peak))
        dkv["earlier_bound_ms"] = bound(6 * bnsd + 2 * bns, 8 * d * pairs,
                                    fma_peak)[0]
        if dtype == torch.bfloat16:
            # what the backward's own products take: the bf16 operands one
            # TF32 term, p and ds two, all at TF32's 495 TFLOP/s (the bf16
            # forward's products are the bound's own: bf16 terms at 989)
            for e, n_terms in ((dq, 4), (dkv, 6)):
                e["design_bound_ms"] = (2 * n_terms * d * pairs
                                        / TF32_TENSOR_OPS_PER_S * 1e3)
        fwd["library"] = "SDPA forward, eager"
        for e, kind in ((fwd, "fwd"), (dq, "dq"), (dkv, "dkv")):
            e["first_design_ms"] = statistics.median(
                design[kind][fmha.PATH_SIMT]) / 1e3
        for e in (dq, dkv):
            e["library_ms"] = sdpa_bwd_ms
            e["library"] = "SDPA backward, dq+dk+dv: fwd+bwd - fwd, eager"
        o = r["o"][0]
        delta_ms = device_ms(lambda: fmha._delta(o, do))
        pair = dq["ms"] + dkv["ms"]
        log(f"kernel flash backward pair at the path shape "
            f"({str(dtype)[6:]}): dq + dk/dv {_us(pair)}, with the delta "
            f"pass {_us(pair + delta_ms)} (delta {_us(delta_ms)}); SDPA's "
            f"backward {_us(sdpa_bwd_ms)}: pair / SDPA "
            f"{pair / sdpa_bwd_ms:.4f}, with delta "
            f"{(pair + delta_ms) / sdpa_bwd_ms:.4f}; first designs "
            f"{_us(dq['first_design_ms'] + dkv['first_design_ms'])}")
        log(f"kernel flash_fwd at the path shape ({str(dtype)[6:]}): "
            f"{_us(fwd['ms'])}, first design {_us(fwd['first_design_ms'])} "
            f"({fwd['first_design_ms'] / fwd['ms']:.3f}x), SDPA "
            f"{_us(sdpa_fwd_ms)} (kernel / SDPA "
            f"{fwd['ms'] / sdpa_fwd_ms:.4f}), {fwd['bound_ms'] / fwd['ms']:.3f} "
            f"of its bound")
        entries += [fwd, dq, dkv]
        del q, k, v, do, r, args, ql, kl, vl, o
        torch.cuda.empty_cache()
    entries.append(_flash_mha_entry(gen))
    return entries


def _adam_state(gen, shapes):
    """fp32 g, p, m, v lists on the card (v >= 0)."""
    def each(fn):
        return [fn(s) for s in shapes]
    g = each(lambda s: torch.randn(s, generator=gen, device="cuda"))
    p = each(lambda s: torch.randn(s, generator=gen, device="cuda"))
    m = each(lambda s: 0.1 * torch.randn(s, generator=gen, device="cuda"))
    v = each(lambda s: 0.01 * torch.rand(s, generator=gen, device="cuda"))
    return g, p, m, v


def _max_errs(got, want):
    """(max abs err, max abs err / max |want|) over lists of tensors."""
    pairs = [(a, b) for a, b in zip(got, want) if b.numel()]
    err = max(max_abs(a, b) for a, b in pairs)
    ref = max(b.abs().max().item() for _, b in pairs)
    return err, err / ref


def _adam_raw(path, noop, g, p, m, v, *, lr, bc1, bc2, b1, b2, eps,
              weight_decay, adam_w):
    """Kernel #12 over the lists, launched through its C function on
    ``path`` (0 the first design, 1 the streaming body, 2/3 planted
    faults) as the wrapper launches it, uncounted."""
    from apex_tpu_torch.kernels import optim
    optim.launch_adam(noop, g, p, m, v, None, lr=lr, bc1=bc1, bc2=bc2, b1=b1,
                      b2=b2, eps=eps, weight_decay=weight_decay,
                      adam_w=adam_w, path=path)


# planted #12 faults: (what, path code of apex_adam)
ADAM_FAULTS = (("m * (1 / bc1) for m / bc1", 2),
               ("the scalar tails unwritten", 3))


def _equal_lists(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _flat_views(gen, sizes, offsets, mixed):
    """fp32 g, p, m, v lists of ``sizes`` whose tensors are views into
    one flat buffer a list, tensor k at ``offsets[k]`` bytes past a
    16-byte boundary (``mixed``: g's views 4 bytes further on, so no
    16-byte access serves all four arrays)."""
    state = []
    for which, (fill, scale) in enumerate(((torch.randn, 1.0),
                                           (torch.randn, 1.0),
                                           (torch.randn, 0.1),
                                           (torch.rand, 0.01))):
        shift = 4 if mixed and which == 0 else 0
        starts, at = [], 0
        for n, off in zip(sizes, offsets):
            at = -(-at // 4) * 4 + (off + shift) % 16 // 4  # on the offset
            starts.append(at)
            at += n
        flat = scale * fill(at + 4, generator=gen, device="cuda")
        state.append([flat[st:st + n] for st, n in zip(starts, sizes)])
    for ts in state:
        for t, off in zip(ts, offsets):
            assert t.numel() == 0 or t.data_ptr() % 16 == (
                (off + 4) % 16 if mixed and ts is state[0] else off)
    return state


def _clone_views(ts):
    """Copies of views into one flat buffer at the same byte offsets (a
    clone of each view would start on a fresh 16-byte boundary)."""
    flat = ts[0]._base.clone()
    return [flat[t.storage_offset():t.storage_offset() + t.numel()]
            for t in ts]


def check_adam(gen):
    """Multi-tensor Adam #12: options off the path over more tensors than
    one launch's table holds; views at 4-, 8- and 12-byte offsets into
    flat buffers (the streaming body's scalar heads and tails), its two
    planted faults there; then FusedAdam's step over TinyLlama-1.1B's 179
    fp32 tensors: the streaming body bit-identical to the first design and
    to the plain version, the first design timed beside it in turns,
    ``torch._fused_adamw_`` on the same clocks."""
    from apex_tpu_torch.kernels import optim, registry
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.ops.multi_tensor import bias_corrections

    def run_both(g, p, m, v, noop, lr, b1, b2, eps, wd, adam_w, bc):
        """Kernel and plain version on copies of the same state; returns
        both (p, m, v) and the kernel's launches."""
        kw = dict(lr=lr, bc1=bc[0], bc2=bc[1], b1=b1, b2=b2, eps=eps,
                  weight_decay=wd, adam_w=adam_w)
        ker = [[t.clone() for t in ts] for ts in (p, m, v)]
        pln = [[t.clone() for t in ts] for ts in (p, m, v)]
        before = registry.launches()["adam"]
        optim.adam(noop, g, *ker, **kw)
        launched = registry.launches()["adam"] - before
        optim.adam_plain(noop, g, *pln, **kw)
        torch.cuda.synchronize()
        return ker, pln, launched

    noop0 = torch.zeros(1, device="cuda")
    # options the path does not take, over more tensors than one launch's
    # table holds, with sizes from 0 to several chunks
    sizes = [0, 1, 3, 255, 65536, 65537, 200003] + [
        int(n) for n in torch.randint(1, 5000, (140,), generator=gen,
                                      device="cuda").tolist()]
    g, p, m, v = _adam_state(gen, [(n,) for n in sizes])
    for adam_w, wd, step, corrected in ((False, 0.01, 1, True),
                                        (True, 0.01, 5, True),
                                        (True, 0.0, 2, False),
                                        (False, 0.0, 3, True)):
        bc = bias_corrections(0.9, 0.999, step) if corrected else (1.0, 1.0)
        ker, pln, launched = run_both(g, p, m, v, noop0, 1e-3, 0.9, 0.999,
                                      1e-8, wd, adam_w, bc)
        assert launched == math.ceil(len(sizes) / optim.MAX_TENSORS)
        for a, b in zip(ker, pln):
            _, rel = _max_errs(a, b)
            assert rel <= ADAM_RTOL, (adam_w, wd, step, rel)
    # the noop flag leaves p, m and v bit-identical
    ker, _, _ = run_both(g, p, m, v, torch.ones(1, device="cuda"), 1e-3,
                         0.9, 0.999, 1e-8, 0.01, True,
                         bias_corrections(0.9, 0.999, 1))
    for a, b in zip(ker, (p, m, v)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), "noop moved"
    log(f"kernels: adam over {len(sizes)} tensors "
        f"({math.ceil(len(sizes) / optim.MAX_TENSORS)} launches, L2 and "
        f"decoupled decay, with and without bias correction) matches its "
        f"plain version; noop = 1 leaves p, m, v bit-identical")
    del g, p, m, v, ker, pln

    # views into flat buffers: scalar heads and tails beside the vectors
    # (lr 0.5: an ulp of the update shows in p)
    kw = dict(lr=0.5, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              adam_w=False)
    kw["bc1"], kw["bc2"] = bias_corrections(0.9, 0.999, 1)
    vsizes = [n for n in (0, 1, 3, 4, 5, 65539) for _ in range(3)]
    offsets = [4, 8, 12] * 6
    covered = {}
    before = registry.launches()
    for mixed in (False, True):
        g, p, m, v = _flat_views(gen, vsizes, offsets, mixed)
        for ts in zip(g, p, m, v):
            span = optim.adam_plan(ts[1].numel(),
                                   [t.data_ptr() % 16 for t in ts])
            for part, count in zip(("head", "vectors", "tail"), span):
                covered[part] = covered.get(part, 0) + count
        runs = {}
        for label, path in (("first", optim.ADAM_FIRST),
                            ("stream", optim.ADAM_STREAM),
                            *((what, code) for what, code in ADAM_FAULTS)):
            state = [_clone_views(ts) for ts in (p, m, v)]
            _adam_raw(path, noop0, g, *state, **kw)
            runs[label] = [t for ts in state for t in ts]
        state = [_clone_views(ts) for ts in (p, m, v)]
        optim.adam_plain(noop0, g, *state, **kw)
        torch.cuda.synchronize()
        plain = [t for ts in state for t in ts]
        assert _equal_lists(runs["stream"], runs["first"]), mixed
        _, rel = _max_errs(runs["stream"], plain)
        assert rel <= ADAM_RTOL, (mixed, rel)
        for what, _ in ADAM_FAULTS:
            caught = not _equal_lists(runs[what], runs["first"])
            views = "g 4 B off p" if mixed else "aligned alike"
            log(f"kernel adam, flat-buffer views ({views}): planted fault "
                f"{what}: {'caught' if caught else 'NOT caught'}"
                f" (max abs err against the first design "
                f"{_max_errs(runs[what], runs['first'])[0]:.3e})")
            assert caught or mixed, what  # no tail when nothing is a vector
    assert registry.launches() == before  # the raw launches are uncounted
    assert all(covered[k] for k in ("head", "vectors", "tail")), covered
    log(f"kernels: adam over {len(vsizes)} views at 4/8/12-byte offsets "
        f"(sizes {sorted(set(vsizes))}; elements as head/vectors*4/tail "
        f"{covered['head']}/{covered['vectors'] * 4}/{covered['tail']}): "
        "the streaming body bit-identical to the first design, within "
        f"{ADAM_RTOL} of the plain version; both planted faults caught")
    del g, p, m, v, runs, state, plain

    # the path: FusedAdam's step over TinyLlama-1.1B's fp32 tensors
    cfg = TransformerConfig(**MODEL, use_flash_attention=False)
    shapes = [tuple(t.shape) for t in
              GPTModel(cfg, device="meta").parameters()]
    n = sum(math.prod(s) for s in shapes)
    g, p, m, v = _adam_state(gen, shapes)
    lr, b1, b2, eps = TRAIN_LR, 0.9, 0.999, 1e-8
    bc = bias_corrections(b1, b2, 1)
    ker, pln, launched = run_both(g, p, m, v, noop0, lr, b1, b2, eps, 0.0,
                                  True, bc)
    err, rel = zip(*(_max_errs(a, b) for a, b in zip(ker, pln)))
    assert max(rel) <= ADAM_RTOL, rel
    kw = dict(lr=lr, bc1=bc[0], bc2=bc[1], b1=b1, b2=b2, eps=eps,
              weight_decay=0.0, adam_w=True)
    # the first design on the same state (the plain copies, reset)
    for ts, src in zip(pln, (p, m, v)):
        for t, s0 in zip(ts, src):
            t.copy_(s0)
    before = registry.launches()
    _adam_raw(optim.ADAM_FIRST, noop0, g, *pln, **kw)
    torch.cuda.synchronize()
    identical = all(_equal_lists(a, b) for a, b in zip(ker, pln))
    assert identical, "the streaming body differs from the first design"
    design = {}
    for path in (optim.ADAM_FIRST, optim.ADAM_STREAM, optim.ADAM_STREAM,
                 optim.ADAM_FIRST):
        design.setdefault(path, []).append(device_ms(
            lambda: _adam_raw(path, noop0, g, *ker, **kw), iters=5,
            replays=2))
    assert registry.launches() == before  # the raw launches are uncounted
    steps = [torch.ones((), device="cuda") for _ in shapes]

    def library():
        torch._fused_adamw_(pln[0], g, pln[1], pln[2], [], steps, lr=lr,
                            beta1=b1, beta2=b2, weight_decay=0.0, eps=eps,
                            amsgrad=False, maximize=False)

    try:
        library_dev = device_ms(library, iters=5, replays=2)
    except RuntimeError as err:  # a graph that does not capture it
        library_dev = None
        log(f"kernel adam: torch._fused_adamw_ not captured in a CUDA "
            f"graph ({err})")
    library_call = call_ms(library, 5, 1)
    result = dict(
        name="adam", shape=f"{len(shapes)} fp32 tensors, {n} params",
        max_abs_err=max(err), max_rel_err=max(rel),
        tolerance=f"rel {ADAM_RTOL} (bit-identical expected)",
        ms=device_ms(lambda: optim.adam(noop0, g, *ker, **kw), iters=5,
                     replays=2),
        call_ms=call_ms(lambda: optim.adam(noop0, g, *ker, **kw), 5, 1),
        plain_ms=call_ms(lambda: optim.adam_plain(noop0, g, *pln, **kw),
                         3, 1),
        library_ms=library_call if library_dev is None else library_dev,
        library="torch._fused_adamw_, "
        + ("eager call" if library_dev is None else "CUDA graph"),
        first_design_ms=statistics.median(design[optim.ADAM_FIRST]))
    result["bound_ms"], result["bound_by"] = bound(28 * n, 15 * n,
                                                    FP32_OPS_PER_S)
    log(f"kernels: adam over the path's {len(shapes)} tensors: "
        f"{launched} launches; bit-identical to the first design")
    log("kernel adam at the path's tensors through the C function (us, "
        "the first design, then the streaming body, in turns): first "
        + "/".join(f"{t * 1e3:.2f}" for t in design[optim.ADAM_FIRST])
        + "; stream "
        + "/".join(f"{t * 1e3:.2f}" for t in design[optim.ADAM_STREAM])
        + f"; the wrapper {_us(result['ms'])} in a graph, "
        f"{_us(result['call_ms'])} a call; torch._fused_adamw_ "
        f"{_us(library_dev)} in a graph, {_us(library_call)} a call: "
        f"call / call {result['call_ms'] / library_call:.4f}"
        + ("" if library_dev is None else
           f", graph / graph {result['ms'] / library_dev:.4f}")
        + f"; first design / wrapper "
        f"{result['first_design_ms'] / result['ms']:.4f}")
    del g, p, m, v, ker, pln
    torch.cuda.empty_cache()
    return [result]


def check_layer_norm(gen):
    """LayerNorm forward and backward-dx: options off the path (fp32 and
    bf16 in and out, no affine, no bias, odd widths, few rows), then the
    path's [8192, 1024] bf16 rows (the GPT-2 step's layers)."""
    from apex_tpu_torch.kernels import norm
    eps = 1e-5
    for rows, h in ((8, 1024), (300, 1000), (3, 4096)):
        w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        b = 0.1 * torch.randn(h, generator=gen, device="cuda")
        for tin in (torch.float32, torch.bfloat16):
            for weight, bias in ((w, b), (None, None), (w, None)):
                x = _randn(gen, rows, h, dtype=tin, scale=3.0) + 1.0
                for tout in (torch.float32, torch.bfloat16):
                    got = norm.ln_fwd(x, weight, bias, eps, tout)
                    want = norm.ln_fwd_plain(x, weight, bias, eps, tout)
                    torch.cuda.synchronize()
                    assert got.dtype == tout and got.shape == x.shape
                    # rounded to the input's dtype first: bf16 if either is
                    rounded = (torch.bfloat16 if torch.bfloat16 in (tin, tout)
                               else torch.float32)
                    assert_close_scaled(got, want, LN_RTOL[rounded])
                for tdy in (torch.float32, torch.bfloat16):
                    dy = _randn(gen, rows, h, dtype=tdy)
                    got = norm.ln_bwd_dx(dy, x, weight, eps)
                    want = norm.ln_bwd_dx_plain(dy, x, weight, eps)
                    torch.cuda.synchronize()
                    assert got.dtype == tin and got.shape == x.shape
                    assert_close_scaled(got, want, LN_RTOL[tin])
    log("kernels: layer_norm and ln_bwd match their plain versions off the "
        "path (fp32/bf16 in and out, with and without weight and bias, "
        "widths 1000 and 4096)")
    _check_ln_fwd_plan(gen, eps)
    _check_ln_bwd_plan(gen, eps)
    # the path: the bf16 residual stream in, bf16 out
    h = GPT2["hidden_size"]
    rows = GPT2_BATCH * GPT2_SEQ
    # the weight in a buffer one vector longer, so that a read one element
    # ahead stays inside it
    w_buf = 1.0 + 0.1 * torch.randn(h + 4, generator=gen, device="cuda")
    w = w_buf[:h]
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    x = _randn(gen, rows, h, scale=3.0)
    dy = _randn(gen, rows, h)
    bf16 = torch.bfloat16
    assert norm.ln_plan(h, 2, 2, True).path == norm.LN_BWD_VECTOR
    got = norm.ln_fwd(x, w, b, eps, bf16)
    want = norm.ln_fwd_plain(x, w, b, eps, bf16)
    assert_close_scaled(got, want, LN_RTOL[bf16])
    first = _ln_fwd_faults_and_design(x, w, b, eps)
    w_lib, b_lib = w.to(bf16), b.to(bf16)  # F.layer_norm takes one dtype
    fwd = entry(
        "layer_norm", f"x [{rows},{h}] bf16->bf16, fp32 weight and bias", got,
        want, f"rtol {LN_RTOL[bf16]} atol 1e-5*max|y|",
        lambda: norm.ln_fwd(x, w, b, eps, bf16),
        lambda: norm.ln_fwd_plain(x, w, b, eps, bf16),
        lambda: torch.nn.functional.layer_norm(x, (h,), w_lib, b_lib, eps),
        bound(rows * h * 2 * 2 + 2 * h * 4, 8 * rows * h, FP32_OPS_PER_S))
    fwd["first_design_ms"] = first
    fwd["library"] = "F.layer_norm, bf16 weight and bias"
    assert norm.ln_plan(h, 2, 2, True).path == norm.LN_BWD_VECTOR
    got = norm.ln_bwd_dx(dy, x, w, eps)
    want = norm.ln_bwd_dx_plain(dy, x, w, eps)
    assert_close_scaled(got, want, LN_RTOL[bf16])
    _ln_bwd_faults_and_design(x, dy, w, eps)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], w_lib, b_lib,
                                                     eps)
    bwd = entry(
        "ln_bwd", f"dy, x [{rows},{h}] bf16 -> dx bf16", got, want,
        f"rtol {LN_RTOL[bf16]} atol 1e-5*max|dx|",
        lambda: norm.ln_bwd_dx(dy, x, w, eps),
        lambda: norm.ln_bwd_dx_plain(dy, x, w, eps),
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [h], mean, rstd, w_lib, b_lib, [True, False, False]),
        bound(rows * h * 2 * 3 + h * 4, 12 * rows * h, FP32_OPS_PER_S))
    return [fwd, bwd]


def _check_ln_fwd_plan(gen, eps):
    """#4 on each branch of its launch plan, every dtype pair of x and y,
    37 rows, with weight and bias, with neither, with weight alone, and
    with both at a 4-byte offset (read element by element): the register
    path with 16-byte accesses (h 256 and the limit), with one element an
    access (h 1001; h 1024 with x at a 4-byte but not 16-byte offset),
    and the block path past the limit (limit + 8); then the other
    callers' rows on the 16-byte path: BERT's heads ([8192, 1024] fp32 in
    and out) and the MHA norm-add ([4096, 1024], the bf16 query widened
    to fp32, fp32 out)."""
    from apex_tpu_torch.kernels import norm
    names = {norm.LN_BWD_BLOCK: "block", norm.LN_BWD_SCALAR: "scalar",
             norm.LN_BWD_VECTOR: "vector"}
    lim = norm.LN_BWD_REG_MAX_H
    rows = 37
    taken = []
    for tin in (torch.float32, torch.bfloat16):
        for tout in (torch.float32, torch.bfloat16):
            in_size = torch.tensor([], dtype=tin).element_size()
            out_size = torch.tensor([], dtype=tout).element_size()
            # rounded to the input's dtype first: bf16 if either is
            rounded = (torch.bfloat16 if torch.bfloat16 in (tin, tout)
                       else torch.float32)
            for h, offset, path in ((256, 0, norm.LN_BWD_VECTOR),
                                    (lim, 0, norm.LN_BWD_VECTOR),
                                    (1001, 0, norm.LN_BWD_SCALAR),
                                    (lim + 8, 0, norm.LN_BWD_BLOCK),
                                    (1024, 4, norm.LN_BWD_SCALAR)):
                w = 1.0 + 0.1 * torch.randn(h + 1, generator=gen,
                                            device="cuda")
                b = 0.1 * torch.randn(h + 1, generator=gen, device="cuda")
                flat = _randn(gen, rows * h + 16 // in_size, dtype=tin,
                              scale=3.0) + 1.0
                x = flat[offset // in_size:][:rows * h].view(rows, h)
                assert x.data_ptr() % 16 == offset
                p = norm.ln_plan(h, in_size, out_size,
                                 x.data_ptr() % 16 == 0)
                assert p.path == path, (h, offset, tin, tout, p)
                for weight, bias in ((w[:h], b[:h]), (None, None),
                                     (w[:h], None), (w[1:], b[1:])):
                    got = norm.ln_fwd(x, weight, bias, eps, tout)
                    want = norm.ln_fwd_plain(x, weight, bias, eps, tout)
                    torch.cuda.synchronize()
                    assert got.dtype == tout and got.shape == x.shape
                    assert_close_scaled(got, want, LN_RTOL[rounded])
                if tin == tout:
                    taken.append(f"{str(tin)[6:]} h {h}"
                                 + (f" x at +{offset} B" if offset else "")
                                 + f": {names[p.path]}"
                                 + (f", {p.vec} an access, {p.iters} chunks "
                                    f"a lane" if p.iters else ""))
    for label, rows, h in (("BERT's heads", BERT_BATCH * BERT_SEQ,
                            BERT["hidden_size"]),
                           ("the MHA norm-add", MHA_SEQ * MHA_BATCH,
                            MHA_HIDDEN)):
        w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        b = 0.1 * torch.randn(h, generator=gen, device="cuda")
        x = _randn(gen, rows, h, dtype=torch.float32, scale=3.0)
        p = norm.ln_plan(h, 4, 4, x.data_ptr() % 16 == 0)
        assert p.path == norm.LN_BWD_VECTOR, (label, p)
        got = norm.ln_fwd(x, w, b, eps, torch.float32)
        want = norm.ln_fwd_plain(x, w, b, eps, torch.float32)
        torch.cuda.synchronize()
        assert_close_scaled(got, want, LN_RTOL[torch.float32])
        taken.append(f"{label} [{rows},{h}] float32: vector, {p.vec} an "
                     f"access, {p.iters} chunks a lane")
    log("kernels: layer_norm matches its plain version on each launch plan "
        "branch, every dtype pair, with and without weight and bias, both "
        "at +4 B (" + "; ".join(taken) + ")")


def _ln_fwd_raw(x, w_ptr, b_ptr, eps, path, out_dtype):
    """#4 launched through its C function on ``path``, uncounted, the
    weight and bias read from ``w_ptr`` and ``b_ptr``: for the first
    design's time and the planted faults."""
    from apex_tpu_torch.kernels import _checks, norm
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rc = norm._ln_kernel()(
        x.data_ptr(), w_ptr, b_ptr, y.data_ptr(), x.shape[0], x.shape[1],
        float(eps), _checks.DTYPE_CODES[x.dtype],
        _checks.DTYPE_CODES[out_dtype], path, _checks.stream(x))
    _checks.status("ln_fwd", rc)
    return y


def _ln_fwd_faults_and_design(x, w, b, eps):
    """At the path shape (bf16 in and out), through #4's C function
    (uncounted): the register path and the first design, and two planted
    faults in the register path (the weight read one element ahead, w in
    a buffer one vector longer; eps raised until rstd moves by about 1 %
    at the median row), held to LN_RTOL against the plain version (the
    faults must read past it); then the first design (one block a row)
    timed beside the register path, in turns. Returns the first design's
    median device ms."""
    from apex_tpu_torch.kernels import norm, registry
    vec, block = norm.LN_BWD_VECTOR, norm.LN_BWD_BLOCK
    bf16 = torch.bfloat16
    before = registry.launches()
    ref = norm.ln_fwd_plain(x, w, b, eps, bf16)
    var = x.float().var(-1, unbiased=False).median().item()
    eps_fault = eps + (1 / 0.99 ** 2 - 1) * var  # rstd * 0.99 at var
    tol = (LN_RTOL[bf16], 1e-5 * ref.float().abs().max().item())

    def raw(path, w_ptr=w.data_ptr(), e=eps):
        return _ln_fwd_raw(x, w_ptr, b.data_ptr(), e, path, bf16)

    readings = {
        "honest": raw(vec), "first design": raw(block),
        "weight read one element ahead": raw(vec, w.data_ptr() + 4),
        f"eps {eps_fault:.4g} (rstd about 1 % low)": raw(vec, e=eps_fault)}
    readings = {k: (_tol_ratio(v, ref, *tol), max_abs(v, ref))
                for k, v in readings.items()}
    log("kernel layer_norm at the path shape: "
        + "; ".join(f"{k}: {r:.3e} of the tolerance (max abs err {e:.3e})"
                    for k, (r, e) in readings.items()))
    honest = ("honest", "first design")
    assert all(readings[k][0] <= 1.0 for k in honest), readings
    assert all(r > 1.0 for k, (r, _) in readings.items() if k not in honest), \
        readings
    design = {}
    for path in (block, vec, vec, block):
        design.setdefault(path, []).append(device_ms(lambda: raw(path)))
    assert registry.launches() == before  # the raw launches are uncounted
    log("kernel layer_norm at the path shape through the C function (us, "
        "the first design's block path, then the register path, in turns): "
        f"block {'/'.join(f'{t * 1e3:.2f}' for t in design[block])}; "
        f"vector {'/'.join(f'{t * 1e3:.2f}' for t in design[vec])}")
    return statistics.median(design[block])


def _check_ln_bwd_plan(gen, eps):
    """#5 on each branch of its launch plan, every dtype pair of dy and
    x, with and without weight, 37 rows: the register path with 16-byte
    accesses (h 256 and the limit), with one element an access (h 1001;
    h 1024 with dy at a 4-byte but not 16-byte offset), and the block
    path past the limit (limit + 8)."""
    from apex_tpu_torch.kernels import norm
    names = {norm.LN_BWD_BLOCK: "block", norm.LN_BWD_SCALAR: "scalar",
             norm.LN_BWD_VECTOR: "vector"}
    lim = norm.LN_BWD_REG_MAX_H
    rows = 37
    taken = []
    for tdy in (torch.float32, torch.bfloat16):
        for tx in (torch.float32, torch.bfloat16):
            dy_size = torch.tensor([], dtype=tdy).element_size()
            x_size = torch.tensor([], dtype=tx).element_size()
            for h, offset, path in ((256, 0, norm.LN_BWD_VECTOR),
                                    (lim, 0, norm.LN_BWD_VECTOR),
                                    (1001, 0, norm.LN_BWD_SCALAR),
                                    (lim + 8, 0, norm.LN_BWD_BLOCK),
                                    (1024, 4, norm.LN_BWD_SCALAR)):
                w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
                x = _randn(gen, rows, h, dtype=tx, scale=3.0) + 1.0
                flat = _randn(gen, rows * h + 16 // dy_size, dtype=tdy)
                dy = flat[offset // dy_size:][:rows * h].view(rows, h)
                assert dy.data_ptr() % 16 == offset
                p = norm.ln_plan(h, dy_size, x_size,
                                 dy.data_ptr() % 16 == 0)
                assert p.path == path, (h, offset, tdy, tx, p)
                for weight in (w, None):
                    got = norm.ln_bwd_dx(dy, x, weight, eps)
                    want = norm.ln_bwd_dx_plain(dy, x, weight, eps)
                    torch.cuda.synchronize()
                    assert got.dtype == tx and got.shape == x.shape
                    assert_close_scaled(got, want, LN_RTOL[tx])
                if tdy == tx:
                    taken.append(f"{str(tx)[6:]} h {h}"
                                 + (f" dy at +{offset} B" if offset else "")
                                 + f": {names[p.path]}"
                                 + (f", {p.vec} an access, {p.iters} chunks "
                                    f"a lane" if p.iters else ""))
    log("kernels: ln_bwd matches its plain version on each launch plan "
        "branch, every dtype pair, with and without weight ("
        + "; ".join(taken) + ")")


def _ln_bwd_raw(dy, x, w_ptr, eps, path):
    """#5 launched through its C function on ``path``, uncounted, the
    weight read from ``w_ptr``: for the first design's time and the
    planted faults."""
    from apex_tpu_torch.kernels import _checks, norm
    dx = torch.empty_like(x)
    rc = norm._ln_bwd_kernel()(
        dy.data_ptr(), x.data_ptr(), w_ptr, dx.data_ptr(), x.shape[0],
        x.shape[1], float(eps), _checks.DTYPE_CODES[dy.dtype],
        _checks.DTYPE_CODES[x.dtype], path, _checks.stream(x))
    _checks.status("ln_bwd_dx", rc)
    return dx


def _ln_bwd_faults_and_design(x, dy, w, eps):
    """At the path shape, through #5's C function (uncounted): the honest
    launch and two planted faults (the weight read one element ahead; eps
    raised until rstd moves by about 1 % at the median row), held to
    LN_RTOL against the plain version (the faults must read past it); then
    the first design (one block a row) timed beside the register path, in
    turns."""
    from apex_tpu_torch.kernels import norm, registry
    vec = norm.LN_BWD_VECTOR
    before = registry.launches()
    ref = norm.ln_bwd_dx_plain(dy, x, w, eps)
    var = x.float().var(-1, unbiased=False).median().item()
    eps_fault = eps + (1 / 0.99 ** 2 - 1) * var  # rstd * 0.99 at var
    tol = (LN_RTOL[torch.bfloat16], 1e-5 * ref.float().abs().max().item())
    readings = {
        "honest": _ln_bwd_raw(dy, x, w.data_ptr(), eps, vec),
        "weight read one element ahead": _ln_bwd_raw(
            dy, x, w.data_ptr() + 4, eps, vec),
        f"eps {eps_fault:.4g} (rstd about 1 % low)": _ln_bwd_raw(
            dy, x, w.data_ptr(), eps_fault, vec)}
    readings = {k: (_tol_ratio(v, ref, *tol), max_abs(v, ref))
                for k, v in readings.items()}
    log("kernel ln_bwd at the path shape: "
        + "; ".join(f"{k}: {r:.3e} of the tolerance (max abs err {e:.3e})"
                    for k, (r, e) in readings.items()))
    assert readings["honest"][0] <= 1.0, readings
    assert all(r > 1.0 for k, (r, _) in readings.items() if k != "honest"), \
        readings
    design = {}
    for path in (norm.LN_BWD_BLOCK, vec, vec, norm.LN_BWD_BLOCK):
        design.setdefault(path, []).append(device_ms(
            lambda: _ln_bwd_raw(dy, x, w.data_ptr(), eps, path)) * 1e3)
    assert registry.launches() == before  # the raw launches are uncounted
    log("kernel ln_bwd at the path shape through the C function (us, the "
        "first design's block path, then the register path, in turns): "
        f"block {'/'.join(f'{t:.2f}' for t in design[norm.LN_BWD_BLOCK])}; "
        f"vector {'/'.join(f'{t:.2f}' for t in design[vec])}")


def _key_mask(gen, shape, share=0.35, nan_row=False):
    """A bool mask (True = masked) with ``share`` of the keys masked and
    key 0 of every row live; with ``nan_row`` one row fully masked."""
    m = torch.rand(*shape, generator=gen, device="cuda") < share
    m[..., 0] = False
    if nan_row:
        m[(0,) * (m.dim() - 2) + (1,)] = True
    return m


def _masked_raw(x, m, scale, path, mask_ptr=None):
    """Kernel #9 (``m`` the [b, n, sq, sk] mask view; None: #8) launched
    through its C function on ``path``, uncounted, the flags read from
    ``mask_ptr`` (default: m's first byte): for the first design's time
    and the planted faults."""
    from apex_tpu_torch.kernels import _checks, softmax
    y = torch.empty_like(x)
    sk = x.shape[-1]
    if m is None:
        ptr, dims, strides = None, (1, 1), (0, 0, 0)
    else:
        ptr = m.data_ptr() if mask_ptr is None else mask_ptr
        dims, strides = m.shape[1:3], m.stride()[:3]
    rc = softmax._masked_kernel()(
        x.data_ptr(), ptr, y.data_ptr(), x.numel() // sk, *dims, sk,
        *strides, float(scale), _checks.DTYPE_CODES[x.dtype], path,
        _checks.stream(x))
    _checks.status("masked_softmax", rc)
    return y


def _tol_ratio(got, want, rtol, atol):
    """The largest |got - want| / (atol + rtol * |want|): at most 1 where
    torch.testing.assert_close passes (NaN against NaN counts 0, NaN
    against a number infinity)."""
    g, w = got.float(), want.float()
    both = torch.isnan(g) & torch.isnan(w)
    r = torch.where(both, 0.0, (g - w).abs() / (atol + rtol * w.abs()))
    return torch.nan_to_num(r, nan=float("inf")).max().item()


def _check_masked_case(x, m, scale, forms=()):
    """#9 with the bool mask ``m`` (with a fully masked row) and with each
    other form of it in ``forms``, then #8, on x against their plain
    versions: fully masked rows NaN, masked keys exactly 0."""
    from apex_tpu_torch.kernels import softmax
    dtype = x.dtype
    full = m.expand(x.shape)
    dead = full.all(-1)
    live = ~dead
    for mask in (m, *forms):
        got = softmax.scaled_masked_softmax_fwd(x, mask, scale)
        want = softmax.scaled_masked_softmax_fwd_plain(x, mask, scale)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert dead.any() and torch.isnan(got[dead]).all(), \
            "a fully masked row is not NaN (the JAX value)"
        assert torch.isnan(want[dead]).all()
        assert (got[full & live[..., None]] == 0).all(), \
            "a masked key is not 0"
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   rtol=SOFTMAX_RTOL[dtype],
                                   atol=SOFTMAX_ATOL)
    got = softmax.scaled_softmax_fwd(x, scale)
    want = softmax.scaled_softmax_fwd_plain(x, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=SOFTMAX_RTOL[dtype], atol=SOFTMAX_ATOL)


def check_masked_softmax(gen):
    """The scaled (no mask) and scaled-masked softmax forwards: options
    off the path (fp32 and bf16, masks broadcast over heads, full ones,
    one [sq, sk] band, a query-side [b, 1, sq, 1] one broadcast over the
    keys, uint8, keys strided in memory, a fully masked row, 16384 keys),
    each branch of the launch plan (register rows with 16-byte and
    one-key accesses, rows sharing a warp, the block path past
    REG_MAX_KEYS; a view at a 4-byte but not 16-byte offset), then the
    BERT step's [64, 16, 128, 128] fp32 scores with its [64, 1, 128, 128]
    mask: the first design's block path timed beside the register path,
    two planted faults through the kernel's own launch, and the softmax
    backward at the same shape."""
    from apex_tpu_torch.kernels import registry, softmax
    for dtype in (torch.float32, torch.bfloat16):
        for xs, ms in (((2, 3, 40, 357), (2, 1, 40, 357)),
                       ((2, 3, 40, 357), (2, 3, 40, 357)),
                       ((3, 2, 128, 128), (128, 128)),
                       ((2, 3, 40, 357), (2, 1, 40, 1)),
                       ((1, 2, 3, softmax.MAX_KEYS), (1, 1, 3,
                                                      softmax.MAX_KEYS))):
            for scale in (1.0, 0.125):
                x = _randn(gen, *xs, dtype=dtype, scale=4.0)
                m = _key_mask(gen, ms, nan_row=True)
                strided = m.transpose(-1, -2).contiguous().transpose(-1, -2)
                _check_masked_case(x, m, scale,
                                   (m.to(torch.uint8), strided))
    log("kernels: scaled_softmax and masked_softmax match their plain "
        "versions off the path (fp32/bf16, masks [b,1,sq,sk], [b,n,sq,sk], "
        "[sq,sk], [b,1,sq,1], bool and uint8, keys strided, 16384 keys); "
        "fully masked rows are NaN (NaN for NaN), masked keys exactly 0")
    # each branch of the launch plan: 2 x 3 x 5 rows (a warp's last group
    # of rows may hold none), a [2, 1, 5, sk] mask with a fully masked row
    names = {softmax.BLOCK: "block", softmax.SCALAR: "scalar",
             softmax.VECTOR: "vector"}
    reg = softmax.REG_MAX_KEYS
    taken = []
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        for sk, offset, path in ((32, 0, softmax.VECTOR),
                                 (128, 0, softmax.VECTOR),
                                 (357, 0, softmax.SCALAR),
                                 (reg, 0, softmax.VECTOR),
                                 (reg + 1, 0, softmax.BLOCK),
                                 (softmax.MAX_KEYS, 0, softmax.BLOCK),
                                 (128, 4, softmax.SCALAR)):
            shape = (2, 3, 5, sk)
            flat = _randn(gen, 2 * 3 * 5 * sk + 16 // size, dtype=dtype,
                          scale=4.0)
            x = flat[offset // size:][:2 * 3 * 5 * sk].view(shape)
            assert x.data_ptr() % 16 == offset
            p = softmax.plan(sk, size, x.data_ptr() % 16 == 0)
            assert p.path == path, (sk, offset, dtype, p)
            for scale in (1.0, 0.125):
                _check_masked_case(x, _key_mask(gen, (2, 1, 5, sk),
                                                 nan_row=True), scale)
            taken.append(f"{str(dtype)[6:]} sk {sk}"
                         + (f" at +{offset} B" if offset else "")
                         + f": {names[p.path]}, {p.lanes} lanes a row")
    log("kernels: scaled_softmax and masked_softmax match their plain "
        "versions on each launch plan branch (" + "; ".join(taken) + ")")
    # the path: BERT-large's scores, its all-ones padding mask (nothing
    # masked) and a partial mask
    b, n, s = BERT_BATCH, BERT["num_attention_heads"], BERT_SEQ
    assert softmax.plan(s, 4, True).path == softmax.VECTOR
    x = _randn(gen, b, n, s, s, dtype=torch.float32, scale=4.0)
    keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask = ~(keep[:, None, None, :] & keep[:, None, :, None])
    # the partial mask in a buffer one flag longer, so that a read one
    # key ahead stays inside it
    nm = b * s * s
    buf = torch.zeros(nm + 16, dtype=torch.bool, device="cuda")
    buf[:nm] = _key_mask(gen, (b, 1, s, s)).reshape(-1)
    partial = buf[:nm].view(b, 1, s, s)
    for m in (partial, mask):
        got = softmax.scaled_masked_softmax_fwd(x, m, 1.0)
        want = softmax.scaled_masked_softmax_fwd_plain(x, m, 1.0)
        torch.testing.assert_close(got, want,
                                   rtol=SOFTMAX_RTOL[torch.float32],
                                   atol=SOFTMAX_ATOL)
    # planted faults through the kernel's own launch (uncounted): flags
    # read one key off, the scale 1e-4 too large
    tol = (SOFTMAX_RTOL[torch.float32], SOFTMAX_ATOL)
    view = partial.expand(b, n, s, s)
    before = registry.launches()
    ref = softmax.scaled_masked_softmax_fwd_plain(x, partial, 1.0)
    readings = {
        "honest": _masked_raw(x, view, 1.0, softmax.VECTOR),
        "mask pointer one byte ahead": _masked_raw(
            x, view, 1.0, softmax.VECTOR, mask_ptr=view.data_ptr() + 1),
        "scale * (1 + 1e-4)": _masked_raw(x, view, 1.0 + 1e-4,
                                          softmax.VECTOR)}
    readings = {k: (_tol_ratio(v, ref, *tol), max_abs(v, ref))
                for k, v in readings.items()}
    log("kernel masked_softmax at the path shape, partial mask: "
        + "; ".join(f"{k}: {r:.3e} of the tolerance (max abs err {e:.3e})"
                    for k, (r, e) in readings.items()))
    assert readings["honest"][0] <= 1.0, readings
    assert all(r > 1.0 for k, (r, _) in readings.items() if k != "honest"), \
        readings
    # the first design (one block a row) beside the register path, both
    # through the C function
    mview = mask.expand(b, n, s, s)
    design = {}
    for label, m in (("masked", mview), ("scaled", None)):
        for path in (softmax.BLOCK, softmax.VECTOR, softmax.VECTOR,
                     softmax.BLOCK):
            design.setdefault((label, path), []).append(device_ms(
                lambda: _masked_raw(x, m, 1.0, path)) * 1e3)
    assert registry.launches() == before  # the raw launches are uncounted
    log("kernels: masked/scaled softmax at the path shape through the C "
        "function (us, block path first design then register path, in "
        "turns): " + "; ".join(
            f"{label} {names[path]} "
            + "/".join(f"{t:.2f}" for t in ts)
            for (label, path), ts in design.items()))
    x_filled = x.masked_fill(mask, -10000.0)  # the mask applied before
    nx = b * n * s * s
    masked = entry(
        "masked_softmax", f"x [{b},{n},{s},{s}] fp32, mask [{b},1,{s},{s}] "
        f"bool (bench_bert's all-ones padding), scale 1", got, want,
        f"rtol {SOFTMAX_RTOL[torch.float32]} atol {SOFTMAX_ATOL}",
        lambda: softmax.scaled_masked_softmax_fwd(x, mask, 1.0),
        lambda: softmax.scaled_masked_softmax_fwd_plain(x, mask, 1.0),
        lambda: torch.softmax(x_filled, dim=-1),
        bound(2 * nx * 4 + b * s * s, 5 * nx, FP32_OPS_PER_S))
    got = softmax.scaled_softmax_fwd(x, 1.0)
    want = softmax.scaled_softmax_fwd_plain(x, 1.0)
    torch.testing.assert_close(got, want, rtol=SOFTMAX_RTOL[torch.float32],
                               atol=SOFTMAX_ATOL)
    scaled = entry(
        "scaled_softmax", f"x [{b},{n},{s},{s}] fp32, no mask, scale 1",
        got, want, f"rtol {SOFTMAX_RTOL[torch.float32]} atol {SOFTMAX_ATOL}",
        lambda: softmax.scaled_softmax_fwd(x, 1.0),
        lambda: softmax.scaled_softmax_fwd_plain(x, 1.0),
        lambda: torch.softmax(x, dim=-1),
        bound(2 * nx * 4, 4 * nx, FP32_OPS_PER_S))
    # the softmax backward (#11) at BERT's shape, as each BERT layer runs it
    y = want
    dy = _randn(gen, b, n, s, s, dtype=torch.float32)
    got = softmax.softmax_bwd(y, dy, 1.0)
    ref = softmax.softmax_bwd_plain(y, dy, 1.0)
    assert_close_scaled(got, ref, SOFTMAX_BWD_RTOL[torch.float32])
    first = _softmax_bwd_faults_and_design(y, dy, ref)
    bwd = entry(
        "softmax_bwd", f"y, dy [{b},{n},{s},{s}] fp32, scale 1", got, ref,
        f"rtol {SOFTMAX_BWD_RTOL[torch.float32]} atol 1e-5*max|dx|",
        lambda: softmax.softmax_bwd(y, dy, 1.0),
        lambda: softmax.softmax_bwd_plain(y, dy, 1.0),
        lambda: torch._softmax_backward_data(dy, y, -1, torch.float32),
        bound(3 * nx * 4, 5 * nx, FP32_OPS_PER_S))
    bwd["first_design_ms"] = first
    bwd["library"] = "torch._softmax_backward_data"
    return [scaled, masked, bwd]


def check_lamb(gen):
    """LAMB stage 1: options off the path (L2 and decoupled decay, no
    decay, clipping on and off, no gradient averaging, the noop flag,
    more tensors than one launch takes), then FusedLAMB's step over
    BERT-large's fp32 tensors."""
    import math

    from apex_tpu_torch.kernels import optim, registry
    from apex_tpu_torch.models import BertModel, TransformerConfig
    from apex_tpu_torch.ops.multi_tensor import bias_corrections
    from apex_tpu_torch.transformer.enums import AttnMaskType

    def run_both(g, p, m, v, noop, kw):
        """Kernel and plain version on copies of the same g, m, v; returns
        both (m, v, update) and the kernel's launches."""
        ker = [[t.clone() for t in ts] for ts in (m, v, g)]
        pln = [[t.clone() for t in ts] for ts in (m, v, g)]
        before = registry.launches()["lamb"]
        optim.lamb(noop, ker[2], p, ker[0], ker[1], **kw)
        launched = registry.launches()["lamb"] - before
        optim.lamb_plain(noop, pln[2], p, pln[0], pln[1], **kw)
        torch.cuda.synchronize()
        return ker, pln, launched

    def hyper(step, wd, adam_w, clip, beta3=0.1, b1=0.9, b2=0.999):
        bc1, bc2 = bias_corrections(b1, b2, step)
        return dict(clip=clip, bc1=bc1, bc2=bc2, b1=b1, b2=b2, beta3=beta3,
                    eps=1e-6, weight_decay=wd, adam_w=adam_w)

    noop0 = torch.zeros(1, device="cuda")
    clip = torch.full((1,), 3.7, device="cuda")
    sizes = [0, 1, 3, 255, 65536, 65537, 200003] + [
        int(n) for n in torch.randint(1, 5000, (140,), generator=gen,
                                      device="cuda").tolist()]
    g, p, m, v = _adam_state(gen, [(n,) for n in sizes])
    for kw in (hyper(1, 0.01, True, clip), hyper(3, 0.01, False, clip),
               hyper(2, 0.0, True, None), hyper(1, 0.01, True, None, 1.0)):
        ker, pln, launched = run_both(g, p, m, v, noop0, kw)
        assert launched == math.ceil(len(sizes) / optim.MAX_TENSORS)
        for a, b in zip(ker, pln):
            _, rel = _max_errs(a, b)
            assert rel <= LAMB_RTOL, (kw, rel)
    ker, _, _ = run_both(g, p, m, v, torch.ones(1, device="cuda"),
                         hyper(1, 0.01, True, clip))
    for a, b in zip(ker, (m, v, g)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), "noop moved"
    log(f"kernels: lamb over {len(sizes)} tensors (L2 and decoupled decay, "
        f"clip on and off, beta3 1) matches its plain version; noop = 1 "
        f"leaves g, m, v bit-identical")
    del g, p, m, v, ker, pln

    # the path: FusedLAMB's stage 1 over BERT-large's tensors, clipping on
    cfg = TransformerConfig(**BERT, use_flash_attention=False,
                            attn_mask_type=AttnMaskType.padding)
    shapes = [tuple(t.shape) for t in
              BertModel(cfg, device="meta").parameters()]
    n = sum(math.prod(s) for s in shapes)
    g, p, m, v = _adam_state(gen, shapes)
    kw = hyper(1, BERT_WD, True, clip)
    ker, pln, launched = run_both(g, p, m, v, noop0, kw)
    err, rel = zip(*(_max_errs(a, b) for a, b in zip(ker, pln)))
    assert max(rel) <= LAMB_RTOL, rel
    result = dict(
        name="lamb", shape=f"{len(shapes)} fp32 tensors, {n} params",
        max_abs_err=max(err), max_rel_err=max(rel),
        tolerance=f"rel {LAMB_RTOL} (bit-identical expected)",
        ms=device_ms(lambda: optim.lamb(noop0, ker[2], p, ker[0], ker[1],
                                        **kw), iters=5, replays=2),
        call_ms=call_ms(lambda: optim.lamb(noop0, ker[2], p, ker[0], ker[1],
                                           **kw), 5, 1),
        plain_ms=call_ms(lambda: optim.lamb_plain(noop0, pln[2], p, pln[0],
                                                  pln[1], **kw), 3, 1),
        library_ms=None,
        library="none: no one PyTorch call computes LAMB's stage 1")
    result["bound_ms"], result["bound_by"] = bound(28 * n, 16 * n,
                                                    FP32_OPS_PER_S)
    log(f"kernels: lamb over the path's {len(shapes)} tensors: {launched} "
        f"launches")
    del g, p, m, v, ker, pln
    torch.cuda.empty_cache()
    return [result]


# ------------------------------------------------- phase 2: amp's kernels

# amp's multi-tensor kernels (K1 scale, K2 the device-step Adam, K3 SGD,
# K4 LAMB's mixed-precision stages) against their plain versions on the
# same inputs: elementwise, the same fp32 operations in the same order
# (bias corrections from the same double power on the device), so each is
# expected to equal its plain version bit for bit; held within 2 fp32
# ulps of the largest value, as Adam (ADAM_RTOL), which a bf16 output
# meets only by being equal.
AMP_RTOL = ADAM_RTOL
AMP_LOSS_SCALE = 2.0 ** 16  # amp's initial dynamic scale
# device steps at which #12's output is held to its plain version on the
# host's bias corrections: every step to 2000, then a stride to 100000
AMP_BC_STEPS = (*range(1, 2001), *range(2001, 100001, 97), 100000)


def _o2_shapes(build):
    """(shape, dtype) of each parameter of ``build()`` (a model on the
    meta device) as amp O2 casts it: bf16, the norm layers' fp32."""
    from apex_tpu_torch.amp.frontend import is_norm_name
    return [(tuple(p.shape),
             torch.float32 if is_norm_name(n) else torch.bfloat16)
            for n, p in build().named_parameters()]


def _gpt2_meta():
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    return GPTModel(TransformerConfig(**GPT2, use_flash_attention=True),
                    device="meta")


def _bert_meta():
    from apex_tpu_torch.models import BertModel, TransformerConfig
    from apex_tpu_torch.transformer.enums import AttnMaskType
    return BertModel(TransformerConfig(
        **BERT, use_flash_attention=False,
        attn_mask_type=AttnMaskType.padding), device="meta")


def _like(gen, shapes, scale=1.0, fill=torch.randn, dtype=None):
    return [(fill(s, generator=gen, device="cuda") * scale).to(dtype or dt)
            for s, dt in shapes]


def _clones(*lists):
    return [[None if t is None else t.clone() for t in ts] for ts in lists]


def _hold_lists(what, got, want):
    """(max abs err, max rel err) of lists held within AMP_RTOL; whether
    they are bit-identical."""
    err, rel = _max_errs(got, want)
    assert rel <= AMP_RTOL, (what, err, rel)
    return err, rel, _equal_lists(got, want)


def _fault_log(kernel, what, caught, err):
    log(f"kernel {kernel}: planted fault {what}: "
        f"{'caught' if caught else 'NOT caught'} (max abs err against the "
        f"clean run {err:.3e})")
    assert caught, (kernel, what)


def _amp_entry(name, shape, errs, kernel, plain, library, library_name,
               bound_ms_by, tolerance):
    err, rel, same = errs
    library_ms = None
    if library is not None:
        try:
            library_ms = device_ms(library, iters=5, replays=2)
            library_name += ", CUDA graph"
        except RuntimeError as exc:  # a graph that does not capture it
            log(f"kernel {name}: the library call not captured in a CUDA "
                f"graph ({exc}); timed eagerly")
            library_ms = call_ms(library, 5, 1)
            library_name += ", eager call"
    return dict(name=name, shape=shape, max_abs_err=err, max_rel_err=rel,
                tolerance=f"{tolerance} (bit-identical: {same})",
                ms=device_ms(kernel, iters=5, replays=2),
                call_ms=call_ms(kernel, 5, 1), plain_ms=call_ms(plain, 2, 1),
                library_ms=library_ms, library=library_name,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1])


def _views(gen, sizes, elems, dtype, scale=1.0, fill=torch.randn):
    """``dtype`` tensors of ``sizes`` as views into one flat buffer,
    tensor k starting ``elems[k]`` elements past a 16-byte boundary (the
    streaming bodies' scalar heads)."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    starts, at = [], 0
    for n, e in zip(sizes, elems):
        at = -(-at // per) * per + e % per
        starts.append(at)
        at += n
    flat = (fill(at + per, generator=gen, device="cuda") * scale).to(dtype)
    return [flat[st:st + n] for st, n in zip(starts, sizes)]


def _copies(ts):
    """Copies of a list (views into one buffer keep their offsets)."""
    if ts and all(t is not None and t._base is not None
                  and t._base is ts[0]._base for t in ts):
        return _clone_views(ts)
    return [None if t is None else t.clone() for t in ts]


def _cover(lists, width_of, covered):
    """Adds each tensor's head, vectors * width and tail elements (the
    plan the wrappers give the streaming body) to ``covered``."""
    from apex_tpu_torch.kernels import optim
    for ts in zip(*lists):
        ts = [t for t in ts if t is not None]
        width = width_of([t.dtype for t in ts])
        span = optim.adam_plan(ts[0].numel(),
                               [optim._phase(t, width) for t in ts], width)
        for part, count in zip(("head", "vectors", "tail"),
                               (span.head, span.vectors * width, span.tail)):
            covered[part] = covered.get(part, 0) + count


def _turn_times(times):
    return "/".join(f"{t * 1e3:.2f}" for t in times)


def _check_scale(gen, shapes):
    """K1's streaming body (the wrappers' path 1) at GPT-2 345M's O2
    gradients, in place and out of place, against its plain version and
    its first design (path 0), bit for bit; a planted inf; every dtype
    triple of scale and axpby and views at 2- to 14-byte offsets off the
    path; two planted faults through the streaming body; timed through
    the C function beside its first design, and beside
    torch._amp_foreach_non_finite_check_and_unscale_."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.kernels import scale as ks
    n = sum(math.prod(s) for s, _ in shapes)
    xs = _like(gen, shapes, AMP_LOSS_SCALE)
    inv = torch.full((1,), 1.0 / AMP_LOSS_SCALE, device="cuda")

    def three(what, xs, outs_of, flag0=0.0, ys=None, ab=None):
        """The wrapper (counted), the plain version and the first design
        (uncounted) on copies, in that order: [(outs, flag)]; the wrapper
        held to both bit for bit, outputs and flag."""
        res = []
        for which in ("kernel", "plain", "first"):
            x = _copies(xs)
            outs = x if outs_of is None else _copies(outs_of)
            flag = torch.full((1,), flag0, device="cuda")
            if which == "first":
                ks.launch(ks.SCALE if ab is None else ks.AXPBY, flag, x,
                          x if ys is None else ys, outs,
                          inv.data_ptr() if ab is None else None,
                          *(ab or (0.0, 0.0)), path=ks.FIRST)
            elif ab is None:
                (ks.scale if which == "kernel" else ks.scale_plain)(
                    flag, x, outs, inv)
            else:
                (ks.axpby if which == "kernel" else ks.axpby_plain)(
                    flag, x, ys, outs, *ab)
            res.append((outs, flag))
        torch.cuda.synchronize()
        (k_out, k_flag), (p_out, p_flag), (f_out, f_flag) = res
        errs = _hold_lists(what, k_out, p_out)
        assert errs[2], (what, "not bit-identical to the plain version")
        assert _equal_lists(k_out, f_out), (what, "differs from path 0")
        assert k_flag.item() == p_flag.item() == f_flag.item(), (
            what, k_flag, p_flag, f_flag)
        return res, errs

    before = registry.launches()["multi_tensor_scale"]
    res, errs = three("scale", xs, None)
    launched = registry.launches()["multi_tensor_scale"] - before
    (k_out, k_flag), _, _ = res
    groups = {}
    for _, dt in shapes:
        groups[dt] = groups.get(dt, 0) + 1
    assert launched == sum(math.ceil(c / ks.MAX_TENSORS)
                           for c in groups.values()), launched
    assert k_flag.item() == 0.0
    # a planted inf: all three flag it, everything else as before
    kept = xs[7].view(-1)[123].item()
    xs[7].view(-1)[123] = float("inf")
    res, _ = three("scale, a planted inf", xs, None)
    assert res[0][1].item() == 1.0, res[0][1]
    xs[7].view(-1)[123] = kept
    del res
    # every dtype triple off the path: into the other dtype with a raised
    # flag kept, axpby over each (y, out) dtype pair
    f32, b16 = torch.float32, torch.bfloat16
    small = [((n_,), dt) for n_ in (0, 1, 5, 4099, 70001)
             for dt in (f32, b16)] * 8
    sx = _like(gen, small, 1e3)
    other = [torch.empty(s, device="cuda", dtype=b16 if dt == f32 else f32)
             for s, dt in small]
    res, _ = three("scale into the other dtype", sx, other, flag0=1.0)
    assert res[0][1].item() == 1.0
    for dy in (f32, b16):
        sy = _like(gen, small, 1.0, dtype=dy)
        for dout in (f32, b16):
            outs = [torch.empty(s, device="cuda", dtype=dout)
                    for s, _ in small]
            res, _ = three(f"axpby, y {dy}, out {dout}", sx, outs, ys=sy,
                           ab=(0.3, -1.7))
            assert res[0][1].item() == 0.0
    # views at 2- to 14-byte offsets: scalar heads, vectors and tails at
    # each width; outputs off the inputs' boundary: all head
    vsizes = [n_ for n_ in (0, 1, 3, 5, 9, 17, 4099, 70001) for _ in range(7)]
    elems = [1, 2, 3, 4, 5, 6, 7] * 8
    covered = {}
    view_lists = []
    for dx, dout in ((f32, f32), (b16, b16), (f32, b16), (b16, f32)):
        vx = _views(gen, vsizes, elems, dx, AMP_LOSS_SCALE)
        vo = _views(gen, vsizes, elems, dout)
        off = _views(gen, vsizes, [e + 1 for e in elems], dout)
        view_lists.append(vx)
        three(f"scale, views {dx} in place", vx, None)
        three(f"scale, views {dx} to {dout}", vx, vo)
        three(f"scale, views {dx} to {dout} one element off", vx, off)
        vy = _views(gen, vsizes, elems, dx)
        three(f"axpby, views {dx}, out {dout}", vx, vo, ys=vy, ab=(0.3, -1.7))
        for lists in ((vx, vx), (vx, vo), (vx, off), (vx, vy, vo)):
            _cover(lists, ks.vector_width, covered)
    assert all(covered.get(k) for k in ("head", "vectors", "tail")), covered
    log(f"kernels: multi_tensor_scale over GPT-2 345M's {len(shapes)} O2 "
        f"gradients ({launched} launches) bit-identical to its plain "
        f"version and its first design: {errs[2]}; a planted inf flagged "
        f"by all three; {len(small)} tensors off the path (into the other "
        f"dtype with a raised flag kept; axpby a=0.3 b=-1.7 over every "
        f"dtype triple) and {len(vsizes)} views a list at 1-7 elements "
        f"past a 16-byte boundary (elements as head/vectors/tail "
        f"{covered['head']}/{covered['vectors']}/{covered['tail']}) "
        f"bit-identical to both")
    # planted faults through the streaming body's own launch, uncounted
    before = registry.launches()
    for what, fault in (("the flag never written (the inf planted)", 1),
                        ("each tensor's last element or vector left", 2)):
        xs[7].view(-1)[123] = float("inf") if fault == 1 else kept
        x = [t.clone() for t in xs]
        flag = torch.zeros(1, device="cuda")
        ks.launch(ks.SCALE, flag, x, x, x, inv.data_ptr(), 0.0, 0.0, fault)
        torch.cuda.synchronize()
        if fault == 1:
            caught, err = flag.item() != 1.0, 1.0 - flag.item()
        else:
            err, rel = _max_errs(x, k_out)
            caught = rel > AMP_RTOL
        _fault_log("multi_tensor_scale", what, caught, err)
    xs[7].view(-1)[123] = kept
    # the tail's last element, on the views (tails where sizes are ragged)
    vx = view_lists[1]
    clean, bad = _copies(vx), _copies(vx)
    flag = torch.zeros(1, device="cuda")
    for x, fault in ((clean, 0), (bad, 2)):
        ks.launch(ks.SCALE, flag, x, x, x, inv.data_ptr(), 0.0, 0.0, fault)
    torch.cuda.synchronize()
    err, rel = _max_errs(bad, clean)
    _fault_log("multi_tensor_scale", "each bf16 view's last element left "
               "(its tail's, or its last vector)", rel > AMP_RTOL, err)
    assert registry.launches() == before
    del view_lists, vx, clean, bad
    entries = []
    # timed out of place (the same bytes as in place, the inputs kept):
    # O1's fp32 gradients first, where the yardstick applies, then O2's
    for label, dtype in (("O1 fp32", torch.float32), ("O2", None)):
        xt = (xs if dtype is None else
              _like(gen, [(s, dtype) for s, _ in shapes], AMP_LOSS_SCALE))
        outs = [torch.empty_like(t) for t in xt]
        held = errs
        if dtype is not None:  # this case's own hold
            res, held = three(f"scale {label}", xt, outs)
            del res
        one = torch.ones(1, device="cuda")
        lib_x = [t.clone() for t in xt]
        nbytes = sum(t.numel() * 2 * t.element_size() for t in xt)
        kind = ("fp32" if dtype is not None
                else "bf16 but the norms'")
        design = {}
        before = registry.launches()
        for path in (ks.FIRST, ks.STREAM, ks.STREAM, ks.FIRST):
            design.setdefault(path, []).append(device_ms(
                lambda: ks.launch(ks.SCALE, flag, xt, xt, outs,
                                  inv.data_ptr(), 0.0, 0.0, path=path),
                iters=5, replays=2))
        assert registry.launches() == before
        entry = _amp_entry(
            "multi_tensor_scale", f"GPT-2 345M {label} gradients, "
            f"{len(shapes)} tensors, {n} elements ({kind})", held,
            lambda: ks.scale(flag, xt, outs, inv),
            lambda: ks.scale_plain(flag, xt, outs, inv),
            None if dtype is None else
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                lib_x, flag, one),
            "none: torch._amp_foreach_non_finite_check_and_unscale_ has no "
            "bf16 kernel" if dtype is None else
            "torch._amp_foreach_non_finite_check_and_unscale_ (in place, "
            "scale 1)",
            bound(nbytes, n, FP32_OPS_PER_S), f"rel {AMP_RTOL}")
        entry["first_design_ms"] = statistics.median(design[ks.FIRST])
        log(f"kernel multi_tensor_scale at GPT-2 345M's {label} gradients "
            f"through the C function in turns (us): first design "
            f"{_turn_times(design[ks.FIRST])}; streaming body "
            f"{_turn_times(design[ks.STREAM])}; first design / streaming body "
            f"{entry['first_design_ms'] / statistics.median(design[ks.STREAM]):.4f}"
            f"; bound {entry['bound_ms'] * 1e3:.3f} us")
        entries.append(entry)
        del xt, outs, lib_x
    del xs, k_out
    return entries


def _check_scale_held(gen, shapes, label):
    """K1 unscaling ``label``'s O2 gradients in place (as AmpOptimizer
    does) against its plain version, bit for bit, clean and with an inf
    planted in one gradient: the same outputs and the same flag."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.kernels import scale as ks
    xs = _like(gen, shapes, AMP_LOSS_SCALE)
    inv = torch.full((1,), 1.0 / AMP_LOSS_SCALE, device="cuda")
    groups = {}
    for _, dt in shapes:
        groups[dt] = groups.get(dt, 0) + 1
    at = len(xs) // 2
    for planted in (False, True):
        if planted:
            xs[at].view(-1)[xs[at].numel() // 3] = float("inf")
        res = []
        before = registry.launches()["multi_tensor_scale"]
        for fn in (ks.scale, ks.scale_plain):
            x = [t.clone() for t in xs]
            flag = torch.zeros(1, device="cuda")
            fn(flag, x, x, inv)
            res.append((x, flag))
        launched = registry.launches()["multi_tensor_scale"] - before
        torch.cuda.synchronize()
        assert launched == sum(math.ceil(c / ks.MAX_TENSORS)
                               for c in groups.values()), launched
        (k_out, k_flag), (p_out, p_flag) = res
        assert _equal_lists(k_out, p_out), (label, planted)
        assert k_flag.item() == p_flag.item() == float(planted), (
            label, planted, k_flag, p_flag)
        del res, k_out, p_out
    log(f"kernels: multi_tensor_scale over {label}'s {len(shapes)} O2 "
        f"gradients in place ({launched} launches) bit-identical to its "
        f"plain version, clean and with a planted inf (flagged by both)")
    del xs


def _adam_master_case(gen, shapes, masters, step_at, **over):
    """g, masters, m, v, outs lists and the adam arguments for ``shapes``
    on the device step ``step_at`` (out lists in each shape's dtype;
    ``masters`` False: the parameters are stepped themselves, in their
    dtype)."""
    gs = _like(gen, shapes)
    ps = _like(gen, shapes, 0.03, dtype=torch.float32 if masters else None)
    ms = _like(gen, shapes, 0.1, dtype=torch.float32)
    vs = _like(gen, shapes, 0.01, fill=torch.rand, dtype=torch.float32)
    outs = ([p.to(dt) for p, (_, dt) in zip(ps, shapes)] if masters
            else [None] * len(ps))
    kw = dict(step=torch.full((1,), step_at, dtype=torch.int32,
                              device="cuda"),
              inv_scale=None, lr=GPT2_LR, b1=0.9, b2=0.999, eps=1e-8,
              weight_decay=0.0, adam_w=True)
    kw.update(over)
    return (gs, ps, ms, vs, outs), kw


def _adam_both(noop, lists, kw):
    from apex_tpu_torch.kernels import optim
    gs, *rest = lists
    ker, pln = _clones(*rest), _clones(*rest)
    optim.adam(noop, gs, *ker, **kw)
    optim.adam_plain(noop, gs, *pln, **kw)
    torch.cuda.synchronize()
    return ker, pln


def _flat(lists):
    return [t for ts in lists for t in ts if t is not None]


def _check_adam_steps(gen, noop0):
    """#12 on the device step against its plain version on the host's
    bias corrections (ops.multi_tensor.bias_corrections) at each of
    AMP_BC_STEPS, on one tensor of random moments: a correction an ulp
    off moves most of its 4099 updates. Launched uncounted."""
    from apex_tpu_torch.kernels import optim
    from apex_tpu_torch.ops.multi_tensor import bias_corrections
    (gs, ps, ms, vs, _), kw = _adam_master_case(
        gen, [((4099,), torch.float32)], False, 1)
    kw = {k: v for k, v in kw.items() if k != "step"}
    step = torch.zeros(1, dtype=torch.int32, device="cuda")
    differ = []
    for k in AMP_BC_STEPS:
        step.fill_(k)
        ker, pln = _clones(ps, ms, vs), _clones(ps, ms, vs)
        optim.launch_adam(noop0, gs, *ker, None, step=step, **kw)
        bc1, bc2 = bias_corrections(0.9, 0.999, k)
        optim.adam_plain(noop0, gs, *pln, bc1=bc1, bc2=bc2, **kw)
        if not _equal_lists(_flat(ker), _flat(pln)):
            differ.append(k)
    log(f"kernels: adam on the device step against its plain version on "
        f"the host's bias corrections at {len(AMP_BC_STEPS)} steps from 1 "
        f"to {AMP_BC_STEPS[-1]}: {len(differ)} differ {differ[:5]}")
    assert not differ, differ


def _check_adam_master(gen, shapes):
    """K2, #12 with amp's device step, unscale and masters, at GPT-2
    345M's O2 step (bf16 gradients and parameters, fp32 masters of
    everything, the norms' fp32 parameters written from theirs) and off
    it; its bias corrections against the host's at AMP_BC_STEPS; two
    planted faults."""
    from apex_tpu_torch.kernels import optim, registry
    noop0 = torch.zeros(1, device="cuda")
    _check_adam_steps(gen, noop0)
    # off the path, small tensors, more than one launch's table each group;
    # 16-byte-aligned views, views a bf16 element off, views of mixed
    # offsets (scalar heads, vector spans, tails; all scalar)
    small = [((n_,), dt) for n_ in (0, 1, 3, 4099, 70001)
             for dt in (torch.float32, torch.bfloat16)] * 14
    for masters, over in ((True, dict(inv_scale=torch.full(
                              (1,), 2.0 ** -16, device="cuda"))),
                          (True, dict(adam_w=False, weight_decay=0.01,
                                      step=None, bc1=1.0, bc2=1.0)),
                          (False, dict(weight_decay=0.01)),
                          (False, dict())):
        lists, kw = _adam_master_case(gen, small, masters, 5, **over)
        if "inv_scale" in over:  # gradients as a scaled loss leaves them
            lists[0][:] = [g * AMP_LOSS_SCALE for g in lists[0]]
        ker, pln = _adam_both(noop0, lists, kw)
        _hold_lists(f"adam off the path {sorted(over)}", _flat(ker),
                    _flat(pln))
    ker, _ = _adam_both(torch.ones(1, device="cuda"), lists, kw)
    assert _equal_lists(_flat(ker), _flat(lists[1:])), "noop moved"
    lists, kw = _adam_master_case(gen, small, True, 5)
    for shift in (1, 2, 3):  # every array `shift` elements past a boundary

        def view(t, by):
            return torch.cat([t.new_zeros(by), t])[by:]

        ker = [[view(t, shift) for t in ts] for ts in lists[1:]]
        ker[3] = [view(t, shift + (k % 3 == 0)) for k, t in
                  enumerate(lists[4])]  # some outputs off the others: scalar
        pln = _clones(*lists[1:])
        gv = [view(g, shift) for g in lists[0]]
        optim.adam(noop0, gv, *ker, **kw)
        optim.adam_plain(noop0, gv, *pln, **kw)
        torch.cuda.synchronize()
        _hold_lists(f"adam off the path, views {shift} elements on",
                    _flat(ker), _flat(pln))
    # the path
    lists, kw = _adam_master_case(gen, shapes, True, 1)
    before = registry.launches()["adam"]
    ker, pln = _adam_both(noop0, lists, kw)
    launched = registry.launches()["adam"] - before
    errs = _hold_lists("adam", _flat(ker), _flat(pln))
    log(f"kernels: adam at GPT-2 345M's O2 step ({len(shapes)} tensors, "
        f"{launched} launches) bit-identical to its plain version: "
        f"{errs[2]}; off the path (inv_scale, L2 decay without bias "
        f"correction, bf16 parameters without masters, views off the "
        f"vector boundary) match; noop = 1 leaves everything bit-identical")
    # planted faults at step 5 on the bf16 tensors, uncounted
    lists5, kw5 = _adam_master_case(
        gen, [sd for sd in shapes if sd[1] == torch.bfloat16], True, 5)
    clean = _clones(*lists5[1:])
    before = registry.launches()
    optim.launch_adam(noop0, lists5[0], *clean, **kw5)
    for what, path in (("the bias corrections of the step before",
                        optim.ADAM_STEP_BEFORE),
                       ("the parameters left unwritten",
                        optim.ADAM_OUT_UNWRITTEN)):
        bad = _clones(*lists5[1:])
        optim.launch_adam(noop0, lists5[0], *bad, **kw5, path=path)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad), _flat(clean))
        _fault_log("adam", what, rel > AMP_RTOL, err)
    assert registry.launches() == before
    del lists5, clean, bad, pln
    gs, ps, ms, vs, outs = lists
    n = sum(math.prod(s) for s, _ in shapes)
    nbytes = sum(math.prod(s) * (2 * (2 if dt == torch.bfloat16 else 4)
                                 + 24) for s, dt in shapes)
    ker_lists = ker
    entry = _amp_entry(
        "adam", f"GPT-2 345M O2 step, {len(shapes)} tensors, {n} params "
        f"(bf16 gradients and parameters but the norms', fp32 masters, the "
        f"device step)",
        errs, lambda: optim.adam(noop0, gs, *ker_lists, **kw),
        lambda: optim.adam_plain(noop0, gs, *ker_lists, **kw), None,
        "none: no one PyTorch call steps fp32 masters from bf16 gradients "
        "and writes the bf16 parameters",
        bound(nbytes, 15 * n, FP32_OPS_PER_S), f"rel {AMP_RTOL}")
    del gs, ps, ms, vs, outs, ker, ker_lists, lists
    return entry


def _check_sgd(gen, shapes):
    """K3's streaming body (the wrapper's path 1) at GPT-2 345M's fp32 O1
    step (momentum 0.9, the first run and the next) and off it (every
    option, bf16 gradients and outputs, views at 4-, 8- and 12-byte
    offsets), against its plain version and its first design (path 0),
    bit for bit; two planted faults through the streaming body; timed
    through the C function beside its first design, and beside
    torch._fused_sgd_."""
    from apex_tpu_torch.kernels import optim, registry
    noop0 = torch.zeros(1, device="cuda")

    def case(shapes, views=None, **over):
        if views is None:
            gs = _like(gen, shapes)
            ps = _like(gen, shapes, 0.03, dtype=torch.float32)
            moms = _like(gen, shapes, 0.1, dtype=torch.float32)
        else:  # views at element offsets: (g's, the others')
            sizes = [math.prod(s) for s, _ in shapes]
            by_dtype = {dt: _views(gen, sizes, views[0], dt)
                        for dt in {dt for _, dt in shapes}}
            gs = [by_dtype[dt][k] for k, (_, dt) in enumerate(shapes)]
            ps = _views(gen, sizes, views[1], torch.float32, 0.03)
            moms = _views(gen, sizes, views[1], torch.float32, 0.1)
        kw = dict(step=torch.zeros(1, dtype=torch.int32, device="cuda"),
                  inv_scale=None, wd=0.0, momentum=0.9, dampening=0.0,
                  lr=AMP_SGD_LR, nesterov=False, wd_after_momentum=False)
        kw.update(over)
        outs = ([p.to(dt) for p, (_, dt) in zip(ps, shapes)]
                if kw.pop("outs", False) else [None] * len(ps))
        return (gs, ps, moms, outs), kw

    def three(what, noop, lists, kw):
        """The wrapper (counted), the plain version and the first design
        (uncounted) on copies of the state; the wrapper held to both bit
        for bit. Returns the wrapper's and the plain version's state."""
        gs, *rest = lists
        ker, pln, fst = ([_copies(ts) for ts in rest] for _ in range(3))
        optim.sgd(noop, gs, *ker, **kw)
        optim.sgd_plain(noop, gs, *pln, **kw)
        optim.launch_sgd(noop, gs, *fst, **kw, path=optim.SGD_FIRST)
        torch.cuda.synchronize()
        errs = _hold_lists(what, _flat(ker), _flat(pln))
        assert errs[2], (what, "not bit-identical to the plain version")
        assert _equal_lists(_flat(ker), _flat(fst)), (what, "differs from "
                                                      "path 0")
        return ker, pln, errs

    small = [((n_,), dt) for n_ in (0, 1, 3, 4099, 70001)
             for dt in (torch.float32, torch.bfloat16)] * 14
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    options = (dict(inv_scale=torch.full((1,), 0.25, device="cuda")),
               dict(step=one, nesterov=True, wd=0.01, outs=True),
               dict(step=one, dampening=0.1, wd=0.01,
                    wd_after_momentum=True),
               dict(momentum=0.0, wd=0.01))
    for over in options:
        lists, kw = case(small, **over)
        three(f"sgd off the path {sorted(over)}", noop0, lists, kw)
    ker, _, _ = three("sgd, noop raised", torch.ones(1, device="cuda"),
                      lists, kw)
    assert _equal_lists(_flat(ker), _flat(lists[1:])), "noop moved"
    # views 1-3 elements past a 16-byte boundary (4-, 8-, 12-byte offsets
    # of the fp32 state): heads, vectors and tails; g's views one element
    # further on: all head
    vsmall = [((n_,), dt) for n_ in (0, 1, 3, 5, 9, 4099, 70001)
              for dt in (torch.float32, torch.bfloat16) for _ in range(3)]
    elems = [1, 2, 3] * (len(vsmall) // 3)
    covered = {}
    for g_off in (0, 1):
        for over in options[:3]:
            lists, kw = case(vsmall, views=([e + g_off for e in elems],
                                            elems), **over)
            three(f"sgd, views, g {g_off} element(s) off, {sorted(over)}",
                  noop0, lists, kw)
            _cover([ts for ts in lists if ts[0] is not None],
                   lambda dts: 4, covered)
    assert all(covered.get(k) for k in ("head", "vectors", "tail")), covered
    fp32 = [(s, torch.float32) for s, _ in shapes]
    lists, kw = case(fp32)
    before = registry.launches()["sgd"]
    ker, pln, errs0 = three("sgd first run", noop0, lists, kw)
    launched = registry.launches()["sgd"] - before
    kw1 = dict(kw, step=one)
    ker1, pln1, errs = three("sgd", noop0, [lists[0], *ker], kw1)
    log(f"kernels: sgd at GPT-2 345M's fp32 O1 step ({len(shapes)} "
        f"tensors, {launched} launches, momentum 0.9): the first run and "
        f"the next bit-identical to the plain version and the first "
        f"design: {errs0[2]}, {errs[2]}; off the path (inv_scale, "
        f"nesterov, dampening, decay before and after the momentum, bf16 "
        f"gradients, bf16 outputs, no momentum; {len(vsmall)} views a "
        f"list 1-3 elements past a 16-byte boundary, elements as "
        f"head/vectors/tail {covered['head']}/{covered['vectors']}/"
        f"{covered['tail']}) bit-identical to both; noop = 1 leaves "
        f"everything bit-identical")
    # planted faults through the streaming body's own launch, uncounted
    before = registry.launches()
    gs, ps, moms, outs = lists
    for what, fault, fkw in (
            ("first_run never taken", 1, kw),
            ("the gradients not unscaled", 2,
             dict(kw, inv_scale=torch.full((1,), 0.5, device="cuda")))):
        clean, bad = _clones(ps, moms), _clones(ps, moms)
        optim.launch_sgd(noop0, gs, *clean, outs, **fkw)
        optim.launch_sgd(noop0, gs, *bad, outs, **fkw, fault=fault)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad), _flat(clean))
        _fault_log("sgd", what, rel > AMP_RTOL, err)
    n = sum(math.prod(s) for s, _ in shapes)
    kp, km = ker1[0], ker1[1]
    design = {}
    for path in (optim.SGD_FIRST, optim.SGD_STREAM, optim.SGD_STREAM,
                 optim.SGD_FIRST):
        design.setdefault(path, []).append(device_ms(
            lambda: optim.launch_sgd(noop0, gs, kp, km, None, **kw1,
                                     path=path), iters=5, replays=2))
    assert registry.launches() == before
    lib_p, lib_m = [t.clone() for t in kp], [t.clone() for t in km]
    entry = _amp_entry(
        "sgd", f"GPT-2 345M fp32 O1 step, {len(shapes)} tensors, {n} params, "
        f"momentum 0.9", errs,
        lambda: optim.sgd(noop0, gs, kp, km, **kw1),
        lambda: optim.sgd_plain(noop0, gs, kp, km, **kw1),
        lambda: torch._fused_sgd_(
            lib_p, gs, lib_m, weight_decay=0.0, momentum=0.9, lr=AMP_SGD_LR,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False),
        "torch._fused_sgd_", bound(20 * n, 5 * n, FP32_OPS_PER_S),
        f"rel {AMP_RTOL}")
    entry["first_design_ms"] = statistics.median(design[optim.SGD_FIRST])
    log(f"kernel sgd at GPT-2 345M's fp32 step through the C function in "
        f"turns (us): first design {_turn_times(design[optim.SGD_FIRST])}"
        f"; streaming body {_turn_times(design[optim.SGD_STREAM])}; first "
        f"design / streaming body "
        f"{entry['first_design_ms'] / statistics.median(design[optim.SGD_STREAM]):.4f}"
        f"; bound {entry['bound_ms'] * 1e3:.3f} us")
    del lists, ker, pln, ker1, pln1, gs, ps, moms, kp, km, lib_p, lib_m
    return entry


def _check_lamb_mp(gen, shapes):
    """K4, #13's two stages on amp's mixed precision, at BERT-large's O2
    step (stage 1: bf16 gradients but the norms', fp32 masters, the clip
    factor, the device step; stage 2: the factors lr * trust ratio, the
    parameters written in their dtype) and off it; two planted faults in
    each stage."""
    from apex_tpu_torch.kernels import optim, registry
    noop0 = torch.zeros(1, device="cuda")
    clip = torch.full((1,), 3.7, device="cuda")

    def case(shapes, **over):
        gs = _like(gen, shapes)
        ps = _like(gen, shapes, 0.03, dtype=torch.float32)
        ms = _like(gen, shapes, 0.1, dtype=torch.float32)
        vs = _like(gen, shapes, 0.01, fill=torch.rand, dtype=torch.float32)
        us = [torch.zeros_like(p) for p in ps]
        kw = dict(clip=clip, step=torch.ones(1, dtype=torch.int32,
                                             device="cuda"),
                  inv_scale=None, b1=0.9, b2=0.999, beta3=0.1, eps=BERT_EPS,
                  weight_decay=BERT_WD, adam_w=True)
        kw.update(over)
        return (gs, ps, ms, vs, us), kw

    def stage1(noop, found, lists, kw):
        gs, ps, *rest = lists
        ker, pln = _clones(*rest), _clones(*rest)
        optim.lamb(noop, gs, ps, *ker, found_inf=found, **kw)
        optim.lamb_plain(noop, gs, ps, *pln, found_inf=found, **kw)
        torch.cuda.synchronize()
        return ker, pln

    def stage2(noop, found, ps, us, outs, factors):
        ker, pln = _clones(ps, outs), _clones(ps, outs)
        optim.lamb_stage2(noop, found, ker[0], us, ker[1], factors)
        optim.lamb_stage2_plain(noop, found, pln[0], us, pln[1], factors)
        torch.cuda.synchronize()
        return ker, pln

    small = [((n_,), dt) for n_ in (0, 1, 3, 4099, 70001)
             for dt in (torch.float32, torch.bfloat16)] * 14
    for over in (dict(inv_scale=torch.full((1,), 2.0 ** -16,
                                           device="cuda")),
                 dict(adam_w=False, step=None, bc1=1.0, bc2=1.0, clip=None),
                 dict(weight_decay=0.0, beta3=1.0)):
        lists, kw = case(small, **over)
        if "inv_scale" in over:
            lists[0][:] = [g * AMP_LOSS_SCALE for g in lists[0]]
        ker, pln = stage1(noop0, None, lists, kw)
        _hold_lists(f"lamb off the path {sorted(over)}", _flat(ker),
                    _flat(pln))
    found = torch.ones(1, device="cuda")
    ker, _ = stage1(noop0, found, lists, kw)
    assert _equal_lists(_flat(ker), _flat(lists[2:])), "found_inf moved"
    factors = torch.rand(len(small), generator=gen, device="cuda") * 1e-3
    outs = [p.to(dt) for p, (_, dt) in zip(lists[1], small)]
    for o in (outs, [None] * len(outs)):
        ker, pln = stage2(noop0, None, lists[1], lists[4], o, factors)
        _hold_lists("lamb_stage2 off the path", _flat(ker), _flat(pln))
    ker, _ = stage2(noop0, found, lists[1], lists[4], outs, factors)
    assert _equal_lists(_flat(ker), _flat([lists[1], outs])), "moved"
    # the path
    lists, kw = case(shapes)
    gs, ps, ms, vs, us = lists
    before = registry.launches()
    ker, pln = stage1(noop0, None, lists, kw)
    errs1 = _hold_lists("lamb", _flat(ker), _flat(pln))
    factors = torch.rand(len(shapes), generator=gen, device="cuda") * 1e-3
    outs = [p.to(dt) for p, (_, dt) in zip(ps, shapes)]
    upd = ker[2]
    ker2, pln2 = stage2(noop0, None, ps, upd, outs, factors)
    errs2 = _hold_lists("lamb_stage2", _flat(ker2), _flat(pln2))
    launched = {k: registry.launches()[k] - before[k]
                for k in ("lamb", "lamb_stage2")}
    log(f"kernels: lamb and lamb_stage2 at BERT-large's O2 step "
        f"({len(shapes)} tensors, launches {launched}) bit-identical to "
        f"their plain versions: {errs1[2]}, {errs2[2]}; off the path "
        f"(inv_scale, L2 decay, no clip, no bias correction, no decay, "
        f"no outputs) match; found_inf = 1 leaves everything bit-identical")
    before = registry.launches()
    kinv = dict(kw, inv_scale=torch.full((1,), 0.5, device="cuda"))
    for what, fault, fkw in (("stage 1: the gradients not unscaled", 1,
                              kinv),
                             ("stage 1: the clip factor not applied", 2,
                              kw)):
        clean, bad = _clones(ms, vs, us), _clones(ms, vs, us)
        optim.launch_lamb(noop0, gs, ps, *clean, **fkw)
        optim.launch_lamb(noop0, gs, ps, *bad, **fkw, fault=fault)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad), _flat(clean))
        _fault_log("lamb", what, rel > AMP_RTOL, err)
    for what, fault in (("stage 2: tensor k moved by tensor k + 1's factor",
                         1), ("stage 2: the parameters left unwritten", 2)):
        clean, bad = _clones(ps, outs), _clones(ps, outs)
        optim.launch_lamb_stage2(noop0, None, clean[0], upd, clean[1],
                                 factors)
        optim.launch_lamb_stage2(noop0, None, bad[0], upd, bad[1], factors,
                                 fault=fault)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad), _flat(clean))
        _fault_log("lamb_stage2", what, rel > AMP_RTOL, err)
    assert registry.launches() == before
    n = sum(math.prod(s) for s, _ in shapes)
    g_bytes = sum(math.prod(s) * (2 if dt == torch.bfloat16 else 4)
                  for s, dt in shapes)
    km, kv, ku = ker
    kp, ko = ker2
    shape = (f"BERT-large O2 step, {len(shapes)} tensors, {n} params (bf16 "
             f"gradients and parameters but the norms', fp32 masters)")
    e1 = _amp_entry(
        "lamb", shape, errs1,
        lambda: optim.lamb(noop0, gs, ps, km, kv, ku, **kw),
        lambda: optim.lamb_plain(noop0, gs, ps, km, kv, ku, **kw),
        None, "none: no one PyTorch call computes LAMB's stage 1",
        bound(g_bytes + 24 * n, 16 * n, FP32_OPS_PER_S), f"rel {AMP_RTOL}")
    e2 = _amp_entry(
        "lamb_stage2", shape, errs2,
        lambda: optim.lamb_stage2(noop0, None, kp, upd, ko, factors),
        lambda: optim.lamb_stage2_plain(noop0, None, kp, upd, ko, factors),
        None, "none: no one PyTorch call moves fp32 masters by per-tensor "
        "factors and writes the bf16 parameters",
        bound(12 * n + g_bytes, 2 * n, FP32_OPS_PER_S), f"rel {AMP_RTOL}")
    del lists, ker, pln, ker2, pln2, gs, ps, ms, vs, us, km, kv, ku, kp, ko
    del upd, outs
    return [e1, e2]


def check_amp_kernels(gen):
    """amp's four kernels: K1 (multi_tensor_scale) at GPT-2 345M's and
    BERT-large's O2 tensors, K2 (#12 on the device step with masters) at
    GPT-2's, K3 (sgd) at its fp32 ones, K4 (#13's two stages on masters)
    at BERT-large's O2 tensors, each against its plain version, off the
    path, with two planted faults, and timed."""
    gpt2, bert = _o2_shapes(_gpt2_meta), _o2_shapes(_bert_meta)
    entries = _check_scale(gen, gpt2)
    torch.cuda.empty_cache()
    _check_scale_held(gen, bert, "BERT-large")
    torch.cuda.empty_cache()
    entries.append(_check_adam_master(gen, gpt2))
    torch.cuda.empty_cache()
    entries.append(_check_sgd(gen, gpt2))
    torch.cuda.empty_cache()
    entries += _check_lamb_mp(gen, bert)
    torch.cuda.empty_cache()
    return entries


# --------------------------------- phase 2: the rest of the optimizers

# K5 (Adagrad) and K6 (NovoGrad) against their plain versions on the same
# inputs. K5 is elementwise, the same fp32 operations in the same order:
# held bit for bit (within AMP_RTOL, which only equality meets). K6's
# elementwise pass is too, given the second moments: its parameters and
# exp_avgs are held bit for bit against the plain version's pass on the
# kernel's v. Its v is a sum of squares in another order than torch's: held
# within NOVOGRAD_V_RTOL of the plain version's and of a float64 sum. The
# kernel's sum is a chain of at most ~100 fp32 additions for GPT-2's
# largest tensor (16-32 elements a thread, a 5-step butterfly, 8 warps;
# 12.6 k partials over 256 threads, 50 each, then the block again), each
# rounding within 2^-24 of the running sum: ~6e-6 relative; torch's
# pairwise sum is within that too. With the max norm v is exact: held bit
# for bit.
NOVOGRAD_V_RTOL = 1e-5
# the learning rates of the optimizer phases: Adagrad's first step is
# sign-like (g / |g|), as Adam's, so it takes bench_gpt2's Adam rate;
# NovoGrad's step is lr * g / ||g|| a tensor, and 0.01 is NovoGrad's
# usual rate (Jasper's recipe, with decay 0.001 and betas 0.95, 0.98)
ADAGRAD_LR = GPT2_LR
NOVOGRAD_LR = 0.01
NOVOGRAD_BETAS, NOVOGRAD_WD = (0.95, 0.98), 0.001
# device steps at which K6's bias correction is held (the update given
# the kernel's v, bit for bit against the plain version's)
NOVOGRAD_BC_STEPS = (1, 2, 3, 10, 977, 100000)


def _optim_views(gen, shapes, views):
    """Gradients of ``shapes`` (each its dtype) as views ``views[0]``
    elements past a 16-byte boundary, as _check_sgd lays them out; and
    the sizes."""
    sizes = [math.prod(s) for s, _ in shapes]
    by_dtype = {dt: _views(gen, sizes, views[0], dt)
                for dt in {dt for _, dt in shapes}}
    return [by_dtype[dt][k] for k, (_, dt) in enumerate(shapes)], sizes


def _check_adagrad(gen, shapes):
    """K5 at GPT-2 345M's fp32 tensors (FusedAdagrad's step in the
    adagrad_gpt2 phase: mode 0, no decay, no scale) and off the path
    (decay in each mode, the scale's division, bf16 gradients, bf16
    outputs, noop, views 1-3 elements past a 16-byte boundary) against its
    plain version, bit for bit; two planted faults through its own launch;
    timed beside torch._fused_adagrad_ where that runs on CUDA tensors."""
    from apex_tpu_torch.kernels import optim, registry
    noop0 = torch.zeros(1, device="cuda")
    four = torch.full((1,), 4.0, device="cuda")

    def case(shapes, views=None, **over):
        if views is None:
            gs = _like(gen, shapes)
            ps = _like(gen, shapes, 0.03, dtype=torch.float32)
            hs = _like(gen, shapes, 0.01, fill=torch.rand,
                       dtype=torch.float32)
        else:
            gs, sizes = _optim_views(gen, shapes, views)
            ps = _views(gen, sizes, views[1], torch.float32, 0.03)
            hs = _views(gen, sizes, views[1], torch.float32, 0.01,
                        fill=torch.rand)
        kw = dict(lr=ADAGRAD_LR, eps=1e-10, weight_decay=0.0, mode=0,
                  scale=None)
        kw.update(over)
        outs = ([p.to(dt) for p, (_, dt) in zip(ps, shapes)]
                if kw.pop("outs", False) else [None] * len(ps))
        return (gs, ps, hs, outs), kw

    def both(what, noop, lists, kw):
        gs, *rest = lists
        ker, pln = ([_copies(ts) for ts in rest] for _ in range(2))
        optim.adagrad(noop, gs, *ker, **kw)
        optim.adagrad_plain(noop, gs, *pln, **kw)
        torch.cuda.synchronize()
        errs = _hold_lists(what, _flat(ker), _flat(pln))
        assert errs[2], (what, "not bit-identical to the plain version")
        return ker, errs

    small = [((n_,), dt) for n_ in (0, 1, 3, 4099, 70001)
             for dt in (torch.float32, torch.bfloat16)] * 14
    options = (dict(mode=1, weight_decay=0.01),
               dict(mode=0, weight_decay=0.01, scale=four),
               dict(mode=1, weight_decay=0.01, scale=four, outs=True),
               dict(mode=0, outs=True))
    for over in options:
        lists, kw = case(small, **over)
        both(f"adagrad off the path {sorted(over)}", noop0, lists, kw)
    ker, _ = both("adagrad, noop raised", torch.ones(1, device="cuda"),
                  lists, kw)
    assert _equal_lists(_flat(ker), _flat(lists[1:])), "noop moved"
    vsmall = [((n_,), dt) for n_ in (0, 1, 3, 5, 9, 4099, 70001)
              for dt in (torch.float32, torch.bfloat16) for _ in range(3)]
    elems = [1, 2, 3] * (len(vsmall) // 3)
    covered = {}
    for g_off in (0, 1):
        for over in options[:3]:
            lists, kw = case(vsmall, views=([e + g_off for e in elems],
                                            elems), **over)
            both(f"adagrad, views, g {g_off} element(s) off, "
                 f"{sorted(over)}", noop0, lists, kw)
            _cover([ts for ts in lists if ts[0] is not None],
                   lambda dts: 4, covered)
    assert all(covered.get(k) for k in ("head", "vectors", "tail")), covered
    fp32 = [(s, torch.float32) for s, _ in shapes]
    lists, kw = case(fp32)
    before = registry.launches()["adagrad"]
    ker, errs = both("adagrad at GPT-2 345M's step", noop0, lists, kw)
    launched = registry.launches()["adagrad"] - before
    assert launched == math.ceil(len(shapes) / optim.MAX_TENSORS), launched
    log(f"kernels: adagrad at GPT-2 345M's fp32 step ({len(shapes)} "
        f"tensors, {launched} launches) bit-identical to its plain "
        f"version: {errs[2]}; off the path (decay in each mode, the "
        f"scale's division, bf16 gradients, bf16 outputs; {len(vsmall)} "
        f"views a list 1-3 elements past a 16-byte boundary, elements as "
        f"head/vectors/tail {covered['head']}/{covered['vectors']}/"
        f"{covered['tail']}) bit-identical; noop = 1 leaves everything "
        f"bit-identical")
    before = registry.launches()
    gs, ps, hs, outs = lists
    for what, fault, fkw in (("the denominator from the old sum", 1, kw),
                             ("the gradients not divided by the scale", 2,
                              dict(kw, scale=four))):
        clean, bad = _clones(ps, hs), _clones(ps, hs)
        optim.launch_adagrad(noop0, gs, *clean, outs, **fkw)
        optim.launch_adagrad(noop0, gs, *bad, outs, **fkw, fault=fault)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad), _flat(clean))
        _fault_log("adagrad", what, rel > AMP_RTOL, err)
    assert registry.launches() == before
    n = sum(math.prod(s) for s, _ in shapes)
    kp, kh = ker[0], ker[1]
    lib_p, lib_h = [t.clone() for t in kp], [t.clone() for t in kh]
    lib_steps = [torch.ones((), device="cuda") for _ in kp]

    def library():
        torch._fused_adagrad_(lib_p, gs, lib_h, lib_steps, lr=ADAGRAD_LR,
                              lr_decay=0.0, weight_decay=0.0, eps=1e-10,
                              maximize=False)

    library_name = "torch._fused_adagrad_"
    try:
        library()
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - logged; the library is none
        log(f"kernel adagrad: torch._fused_adagrad_ on CUDA tensors: "
            f"{type(exc).__name__}: {str(exc)[:200]}")
        library, library_name = None, ("none: torch._fused_adagrad_ "
                                       "refuses CUDA tensors")
    entry = _amp_entry(
        "adagrad", f"GPT-2 345M fp32 step, {len(shapes)} tensors, {n} "
        f"params", errs,
        lambda: optim.adagrad(noop0, gs, kp, kh, **kw),
        lambda: optim.adagrad_plain(noop0, gs, kp, kh, **kw), library,
        library_name, bound(20 * n, 7 * n, FP32_OPS_PER_S), f"rel {AMP_RTOL}")
    del lists, ker, gs, ps, hs, kp, kh, lib_p, lib_h
    return entry


def _v64(gs, v_prev, slots, kw):
    """K6's new second moments from float64 sums of the fp32 gradients
    (divided by the scale in fp32), for the tensors' slots."""
    norms = []
    for g in gs:
        g32 = g.float() if kw["scale"] is None else (
            g.float() / kw["scale"].reshape(()))
        if kw["norm_type"] == 2:
            norms.append((g32.double() ** 2).sum())
        elif g32.numel():
            norms.append(g32.double().abs().amax() ** 2)
        else:
            norms.append(torch.zeros((), dtype=torch.float64,
                                     device=g.device))
    norms = torch.stack(norms)
    b2 = kw["b2"]
    if int(kw["step"].item()) == 1:
        return (1 - b2) * norms if kw["init_zero"] else norms
    return b2 * v_prev[slots].double() + (1 - b2) * norms


def _check_novograd(gen, shapes):
    """K6 at GPT-2 345M's fp32 tensors (FusedNovoGrad's step in the
    novograd_gpt2 phase: decoupled decay, L2 norms, the first step and
    later ones) and off the path (the max norm, init_zero, decay into the
    moment, no averaging or bias correction, the scale's division, bf16
    gradients and outputs, v's entries out of order, noop, views 1-3
    elements past a 16-byte boundary): p and m bit for bit against the
    plain version's pass on the kernel's v, v within NOVOGRAD_V_RTOL of the
    plain version's and of float64 sums (bit for bit with the max norm),
    two runs bit-identical; the bias correction at several steps; two
    planted faults through its own launch; timed."""
    from apex_tpu_torch.kernels import optim, registry
    noop0 = torch.zeros(1, device="cuda")
    two = torch.full((1,), 2.0, device="cuda")

    def steps(k):
        return torch.full((1,), k, dtype=torch.int32, device="cuda")

    def case(shapes, views=None, **over):
        if views is None:
            gs = _like(gen, shapes)
            ps = _like(gen, shapes, 0.03, dtype=torch.float32)
            ms = _like(gen, shapes, 0.01, dtype=torch.float32)
        else:
            gs, sizes = _optim_views(gen, shapes, views)
            ps = _views(gen, sizes, views[1], torch.float32, 0.03)
            ms = _views(gen, sizes, views[1], torch.float32, 0.01)
        kw = dict(slots=None, step=steps(2), lr=NOVOGRAD_LR,
                  b1=NOVOGRAD_BETAS[0], b2=NOVOGRAD_BETAS[1],
                  beta3=1 - NOVOGRAD_BETAS[0], eps=1e-8,
                  weight_decay=NOVOGRAD_WD, moment_mode=1, norm_type=2,
                  init_zero=False, bias_correction=True, scale=None)
        kw.update(over)
        outs = ([p.to(dt) for p, (_, dt) in zip(ps, shapes)]
                if kw.pop("outs", False) else [None] * len(ps))
        n = len(ps)
        if kw.pop("shuffled", False):  # v holds more entries, out of order
            kw["slots"] = torch.randperm(n + 5, generator=gen,
                                         device="cuda")[:n].tolist()
        v = torch.rand(n + 5, generator=gen, device="cuda") * 100.0
        return (gs, ps, ms, outs), v, kw

    def run(noop, lists, v, kw, fault=None):
        gs, *rest = lists
        state, vk = [_copies(ts) for ts in rest], v.clone()
        if fault is None:
            optim.novograd(noop, gs, state[0], state[1], vk, state[2], **kw)
        else:
            optim.launch_novograd(noop, gs, state[0], state[1], vk,
                                  state[2], **kw, fault=fault)
        return state, vk

    def both(what, noop, lists, v, kw):
        """The kernel (counted) twice, the plain version's pass on the
        kernel's v and the plain version whole; returns the kernel's state
        and v, and v's largest absolute and relative errors against the
        plain version's and its relative error against float64."""
        gs = lists[0]
        slots = kw["slots"] or list(range(len(gs)))
        ker, vk = run(noop, lists, v, kw)
        again, vk2 = run(noop, lists, v, kw, fault=0)  # uncounted
        given = [_copies(ts) for ts in lists[1:]]
        vg = v.clone()
        optim.novograd_plain(noop, gs, given[0], given[1], vg, given[2],
                             **kw, v_given=vk[slots])
        pln = [_copies(ts) for ts in lists[1:]]
        vp = v.clone()
        optim.novograd_plain(noop, gs, pln[0], pln[1], vp, pln[2], **kw)
        torch.cuda.synchronize()
        assert _equal_lists(_flat(ker) + [vk], _flat(again) + [vk2]), (
            what, "two runs differ")
        assert _equal_lists(_flat(ker) + [vk], _flat(given) + [vg]), (
            what, "the pass on the kernel's v is not the plain version's")
        if noop.item() > 0:
            assert torch.equal(vk, v) and _equal_lists(
                _flat(ker), _flat(lists[1:])), (what, "noop moved")
            return ker, vk, (0.0, 0.0, 0.0)
        want64 = _v64(gs, v, slots, kw)
        got = vk[slots]
        err = (got - vp[slots]).abs()
        rel_plain = (err / vp[slots].abs().clamp_min(1e-30)).max().item()
        rel64 = ((got.double() - want64).abs()
                 / want64.abs().clamp_min(1e-30)).max().item()
        if kw["norm_type"] == 2:
            assert max(rel_plain, rel64) <= NOVOGRAD_V_RTOL, (
                what, rel_plain, rel64)
        else:
            assert torch.equal(vk, vp), (what, "max-norm v differs")
        untouched = [k for k in range(v.numel()) if k not in slots]
        assert torch.equal(vk[untouched], v[untouched]), (what, "other v")
        return ker, vk, (err.max().item(), rel_plain, rel64)

    def worse(a, b):
        return tuple(max(x, y) for x, y in zip(a, b))

    small = [((n_,), dt) for n_ in (0, 1, 3, 4099, 70001, 300007)
             for dt in (torch.float32, torch.bfloat16)] * 12
    options = (dict(norm_type=0, init_zero=True, step=steps(1)),
               dict(moment_mode=0, beta3=1.0, bias_correction=False),
               dict(scale=two, outs=True, shuffled=True),
               dict(init_zero=True, step=steps(1), scale=two),
               dict(norm_type=0, moment_mode=0, outs=True, step=steps(7)))
    worst = (0.0, 0.0, 0.0)
    for over in options:
        lists, v, kw = case(small, **over)
        worst = worse(worst, both(f"novograd off the path {sorted(over)}",
                                  noop0, lists, v, kw)[2])
    both("novograd, noop raised", torch.ones(1, device="cuda"), lists, v, kw)
    vsmall = [((n_,), dt) for n_ in (0, 1, 3, 5, 9, 4099, 70001)
              for dt in (torch.float32, torch.bfloat16) for _ in range(3)]
    elems = [1, 2, 3] * (len(vsmall) // 3)
    covered = {}
    for g_off in (0, 1):
        for over in options[:3]:
            lists, v, kw = case(vsmall, views=([e + g_off for e in elems],
                                               elems), **over)
            both(f"novograd, views, g {g_off} element(s) off, "
                 f"{sorted(over)}", noop0, lists, v, kw)
            _cover([ts for ts in lists if ts[0] is not None],
                   lambda dts: 4, covered)
    assert all(covered.get(k) for k in ("head", "vectors", "tail")), covered
    fp32 = [(s, torch.float32) for s, _ in shapes]
    lists, v, kw = case(fp32, step=steps(1))
    before = registry.launches()["novograd"]
    ker, vk, errs = both("novograd at GPT-2 345M's first step", noop0, lists,
                         v, kw)
    launched = registry.launches()["novograd"] - before
    assert launched == math.ceil(len(shapes) / optim.MAX_TENSORS), launched
    path = errs
    for k in NOVOGRAD_BC_STEPS:
        path = worse(path, both(f"novograd at GPT-2 345M's step {k}", noop0,
                                [lists[0], *ker], vk,
                                dict(kw, step=steps(k)))[2])
    worst = worse(worst, path)
    log(f"kernels: novograd at GPT-2 345M's fp32 step ({len(shapes)} "
        f"tensors, {launched} launches, L2 norms, decoupled decay) and at "
        f"steps {NOVOGRAD_BC_STEPS}: p and m bit-identical to the plain "
        f"version's pass on the kernel's v, two runs bit-identical; v's "
        f"largest relative error on the path {path[1]:.3e} against the "
        f"plain version's, {path[2]:.3e} against float64 sums (off it "
        f"{worst[1]:.3e}, {worst[2]:.3e}; tolerance {NOVOGRAD_V_RTOL}); off "
        f"the path (the max norm, bit-identical v; init_zero, decay into "
        f"the moment, no averaging or bias correction, the scale's "
        f"division, bf16 gradients and outputs, v out of order; "
        f"{len(vsmall)} views a list 1-3 elements past a 16-byte boundary, "
        f"elements as head/vectors/tail {covered['head']}/"
        f"{covered['vectors']}/{covered['tail']}); noop = 1 leaves "
        f"everything, v included, bit-identical")
    before = registry.launches()
    first = dict(kw, step=steps(1))
    for what, fault in (("each tensor's last chunk out of its norm", 1),
                        ("the first step's v never taken", 2)):
        clean, vc = run(noop0, lists, v, first, fault=0)
        bad, vb = run(noop0, lists, v, first, fault=fault)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad) + [vb], _flat(clean) + [vc])
        _fault_log("novograd", what, rel > NOVOGRAD_V_RTOL, err)
    assert registry.launches() == before
    n = sum(math.prod(s) for s, _ in shapes)
    gs = lists[0]
    kp, km = ker[0], ker[1]
    kw2 = dict(kw, step=steps(2))
    entry = _amp_entry(
        "novograd", f"GPT-2 345M fp32 step, {len(shapes)} tensors, {n} "
        f"params, L2 norms", (path[0], path[1], True),
        lambda: optim.novograd(noop0, gs, kp, km, vk, **kw2),
        lambda: optim.novograd_plain(noop0, gs, kp, km, vk, **kw2), None,
        "none: no one PyTorch call computes NovoGrad",
        bound(24 * n, 10 * n, FP32_OPS_PER_S),
        f"p, m bit-identical given v; v rel {NOVOGRAD_V_RTOL}")
    del lists, ker, gs, kp, km, vk
    return entry


def _check_lamb_decay(gen, shapes):
    """K4's stage 1 by the route of the public multi_tensor_lamb_stage1: a
    decay a tensor (0 for GPT-2 345M's biases and norms, 0.01 for the
    rest), a launch a distinct value, beta3 given, the clip factor, the
    device step, in each decay mode, against its plain version bit for
    bit; a raised flag; two planted faults through its launch; timed. No
    path of this script takes the route (JAX's FusedLAMB takes one
    decay)."""
    from apex_tpu_torch.kernels import optim, registry
    noop0 = torch.zeros(1, device="cuda")
    fp32 = [(s, torch.float32) for s, _ in shapes]
    decays = [0.0 if len(s) == 1 else 0.01 for s, _ in shapes]
    gs = _like(gen, fp32)
    ps = _like(gen, fp32, 0.03)
    ms = _like(gen, fp32, 0.01)
    vs = _like(gen, fp32, 1e-4, fill=torch.rand)
    us = [torch.zeros_like(p) for p in ps]
    kw = dict(clip=torch.full((1,), 1.5, device="cuda"), b1=0.9, b2=0.999,
              beta3=0.2, eps=1e-6, weight_decay=decays, adam_w=True,
              step=torch.full((1,), 3, dtype=torch.int32, device="cuda"))

    def both(what, noop, kw):
        ker, pln = (_clones(ms, vs, us) for _ in range(2))
        optim.lamb(noop, gs, ps, *ker, **kw)
        optim.lamb_plain(noop, gs, ps, *pln, **kw)
        torch.cuda.synchronize()
        errs = _hold_lists(what, _flat(ker), _flat(pln))
        assert errs[2], (what, "not bit-identical to the plain version")
        return ker, errs

    groups = sum(math.ceil(decays.count(d) / optim.MAX_TENSORS)
                 for d in set(decays))
    before = registry.launches()["lamb"]
    ker, errs = both("lamb stage 1, a decay a tensor", noop0, kw)
    launched = registry.launches()["lamb"] - before
    assert launched == groups, (launched, groups)
    both("lamb stage 1, a decay a tensor, L2", noop0, dict(kw, adam_w=False))
    kept, _ = both("lamb stage 1, noop raised", torch.ones(1, device="cuda"),
                   kw)
    assert _equal_lists(_flat(kept), ms + vs + us), "noop moved"
    log(f"kernels: lamb stage 1 with a decay a tensor (GPT-2 345M's "
        f"{len(shapes)} fp32 tensors: {decays.count(0.0)} at 0, "
        f"{decays.count(0.01)} at 0.01; {launched} launches) bit-identical "
        f"to its plain version in each decay mode; noop = 1 leaves m, v and "
        f"the updates")
    before = registry.launches()
    for what, fault, fkw in (
            ("the gradients not unscaled", 1,
             dict(kw, inv_scale=torch.full((1,), 0.5, device="cuda"))),
            ("the update written unclipped", 2, kw)):
        clean, bad = _clones(ms, vs, us), _clones(ms, vs, us)
        optim.launch_lamb(noop0, gs, ps, *clean, **fkw)
        optim.launch_lamb(noop0, gs, ps, *bad, **fkw, fault=fault)
        torch.cuda.synchronize()
        err, rel = _max_errs(_flat(bad), _flat(clean))
        _fault_log("lamb_stage1_decay", what, rel > AMP_RTOL, err)
    assert registry.launches() == before
    n = sum(math.prod(s) for s, _ in shapes)
    km, kv, ku = ker
    entry = _amp_entry(
        "lamb_stage1_decay", f"GPT-2 345M fp32 tensors, {n} params, two "
        f"decays", errs,
        lambda: optim.lamb(noop0, gs, ps, km, kv, ku, **kw),
        lambda: optim.lamb_plain(noop0, gs, ps, km, kv, ku, **kw), None,
        "none: no one PyTorch call computes LAMB's stage 1",
        bound(28 * n, 16 * n, FP32_OPS_PER_S), f"rel {AMP_RTOL}")
    del gs, ps, ms, vs, us, ker, km, kv, ku
    return entry


def check_optimizer_kernels(gen):
    """K5 and K6 at GPT-2 345M's fp32 tensors, and K4's stage 1 by the
    public op's per-tensor-decay route, each against its plain version,
    off the path, with two planted faults, and timed."""
    gpt2 = _o2_shapes(_gpt2_meta)
    entries = []
    for check in (_check_adagrad, _check_novograd, _check_lamb_decay):
        entries.append(check(gen, gpt2))
        torch.cuda.empty_cache()
    return entries


# ------------------------------------------- phase 2: int8 serving kernels

def _mixed_offsets(b, hi, gen):
    """int32 [b] offsets in [0, hi) on the card, spread over the range."""
    return torch.randint(0, hi, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)


def check_per_row_attention(gen):
    """#21 and #25 with each batch row at its own offset (the serving
    engine's slots), against their plain versions."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import fused_cc
    n, g = MODEL["num_attention_heads"], MODEL["num_query_groups"]
    d, rep, T = MODEL["hidden_size"] // n, n // g, MODEL[
        "max_position_embeddings"]
    for w, window, cap in ((1, None, None), (5, None, None),
                           (PROMPT, None, None), (5, 50, 30.0)):
        starts = _mixed_offsets(BATCH, T - w + 1, gen)
        starts[0], starts[-1] = 0, T - w  # both ends of the cache
        q = _randn(gen, w, BATCH, g, rep, d)
        k, v = _cache(gen, T, BATCH, g, d, T)
        got = fused_cc.window_attention(q, k, v, starts, d ** -0.5, window,
                                        cap)
        want = fused_cc.window_attention_plain(q, k, v, starts, d ** -0.5,
                                               window, cap)
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        lengths = starts + 1
        got = gqa_decode.gqa_flash_decode(q[0], k, v, lengths, d ** -0.5,
                                          window, cap)
        want = gqa_decode.gqa_decode_plain(q[0], k, v, lengths, d ** -0.5,
                                           window, cap)
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    torch.cuda.synchronize()
    log("kernels: window_attention and gqa_decode with per-row starts and "
        "lengths (w 1, 5, 128; a window and softcap) match their plain "
        f"versions within {ATTN_TOL}")


def _kv_raw(q, k, v, offsets, splits):
    """Kernel #21 (q [w, b, g, rep, d], ``offsets`` the starts) or #25 (q
    [b, g, rep, d], the lengths) launched through its C function with S
    forced to ``splits``, uncounted: for the split checks and the planted
    faults."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import _checks, fused_cc, kv_attention
    window_kernel = q.dim() == 5
    w, (b, g, rep, d) = (q.shape[0], q.shape[1:]) if window_kernel else (
        1, q.shape)
    out = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    splits, scratch, counters = kv_attention.workspace(
        q.device, w * rep, b * g, d, splits)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    dims = (w, b, g, rep, d) if window_kernel else (b, g, rep, d)
    rc = (fused_cc._kernel() if window_kernel else gqa_decode._kernel())(
        *head, *dims, k.shape[0], offsets.data_ptr(), 0, d ** -0.5, 0.0,
        _checks.DTYPE_CODES[q.dtype], splits, _checks.data_ptr(scratch),
        _checks.data_ptr(counters), _checks.stream(q))
    _checks.status("window_attention" if window_kernel else "gqa_decode", rc)
    return out


def check_kv_splits(gen):
    """#21 and #25 through their C functions at S = 1, at the planned S and
    at S = 16, at the path shapes (``generate``'s prefill and decode step),
    the speculative verify and a full 2048-row decode, each within
    ATTN_TOL of the plain version; then planted faults, the starts or
    lengths one key short, which must read past ATTN_TOL. A range uses
    one split for every kv_attention.MIN_SPLIT_STEPS steps, at most S: the
    log names how many the longest row used."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import fused_cc, kv_attention, registry
    n, g = MODEL["num_attention_heads"], MODEL["num_query_groups"]
    d, rep, T = MODEL["hidden_size"] // n, n // g, MODEL[
        "max_position_embeddings"]
    sm = d ** -0.5
    verify = _mixed_offsets(BATCH, T - SPEC_K, gen)
    verify[0], verify[-1] = 0, T - SPEC_K - 1
    cases = (("prefill", PROMPT, torch.zeros(BATCH, dtype=torch.int32,
                                             device="cuda")),
             ("verify", SPEC_K + 1, verify),
             ("decode", 1, torch.full((BATCH,), DECODE_LENGTH,
                                      dtype=torch.int32, device="cuda")),
             ("decode 2048", 1, torch.full((BATCH,), T, dtype=torch.int32,
                                           device="cuda")))
    before = registry.launches()
    honest, faults = [], []
    for label, w, offsets in cases:
        decode = label.startswith("decode")
        q = _randn(gen, w, BATCH, g, rep, d)
        k, v = _cache(gen, T, BATCH, g, d,
                      int(offsets.max()) + (0 if decode else w))
        if decode:
            q = q[0]
            want = gqa_decode.gqa_decode_plain(q, k, v, offsets, sm)
        else:
            want = fused_cc.window_attention_plain(q, k, v, offsets, sm)
        planned = kv_attention.plan(w * rep, BATCH * g,
                                    kv_attention.sm_count(0))[1]
        for splits in sorted({1, planned, kv_attention.MAX_SPLITS}):
            got = _kv_raw(q, k, v, offsets, splits)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)
            us = device_ms(lambda: _kv_raw(q, k, v, offsets, splits)) * 1e3
            tag = " (planned)" if splits == planned else ""
            start = int(offsets.max()) - (1 if decode else 0)
            rows = kv_attention.ROWS
            last = (w * rep - 1) // rows * rows  # the last row tile
            used = kv_attention.used_splits(
                *kv_attention.live_range(start, last, w * rep, rep, None, T),
                splits)
            honest.append(f"{label} S {splits}{tag} (longest row: {used}) "
                          f"{max_abs(got, want):.3e}, {us:.2f} us")
        short = _kv_raw(q, k, v, offsets - 1, planned)
        err = max_abs(short, want)
        faults.append(f"{label} S {planned} {err:.3e}")
        assert err > ATTN_TOL, (label, err)
    assert registry.launches() == before  # the raw launches are uncounted
    log(f"kernels: window_attention and gqa_decode at forced splits match "
        f"their plain versions within {ATTN_TOL} (max abs error, device "
        f"time): " + "; ".join(honest)
        + "; starts/lengths one key short read " + "; ".join(faults))


def _quant_bytes(rows, n, block, in_bytes):
    nb = -(-n // block)
    return rows * n * in_bytes + rows * nb * block + rows * nb * 4


# planted #15 faults: (what, path code of apex_dequant8)
DEQUANT_FAULTS = (("the neighbouring block's scale", 2),
                  ("each vector read one ahead", 3))


def _dequant_raw(q, s, n, out_dtype, path):
    """#15 through its C function on ``path`` (0 the first design, 1 the
    streaming body, 2/3 DEQUANT_FAULTS), uncounted."""
    from apex_tpu_torch.kernels import quant
    out = torch.empty((q.shape[0], n), dtype=out_dtype, device=q.device)
    return quant._launch_dequant(q, s, out, path)


def _check_dequant_plan(gen):
    """Every branch of ``dequant_plan``, asserted, each held bit for bit
    to the plain version, and every vector case also to the first design
    and through both planted faults (which must not be equal): int8 and
    int32 codes into fp32 and bf16, the serving cache's rows, one-row
    buckets with and without a ragged tail, ragged rows, blocks of 100 and
    of 8, and codes at a 4-byte offset. Returns how many cases took each
    branch."""
    from apex_tpu_torch.kernels import quant
    taken = {quant.VECTOR: 0, quant.SCALAR: 0}
    cases = [(16384, 1, 256, 256, torch.int8), (999, 2, 512, 256, torch.int8),
             (1, 4, 1000, 256, torch.int8), (1, 3, 731, 256, torch.int32),
             (5, 3, 768, 256, torch.int32), (999, 2, 300, 256, torch.int8),
             (64, 10, 1000, 100, torch.int8), (40, 4, 32, 8, torch.int8),
             (40, 4, 16, 4, torch.int32)]
    for rows, nb, n, block, codes in cases:
        hi = 127 if codes == torch.int8 else 5000
        q = torch.randint(-hi, hi + 1, (rows, nb, block), generator=gen,
                          device="cuda").to(codes)
        s = torch.rand(rows, nb, 1, generator=gen, device="cuda") * 0.1
        for out_dtype in (torch.float32, torch.bfloat16):
            path = quant.dequant_plan(rows, n, nb, block, q.element_size(),
                                      out_dtype.itemsize, True)
            want = quant.dequantize_rows_plain(q, s, n, out_dtype)
            got = quant.dequantize_rows(q, s, n, out_dtype)
            assert torch.equal(got, want), (rows, nb, n, block, codes)
            taken[path] += 1
            if path != quant.VECTOR:
                continue
            assert torch.equal(_dequant_raw(q, s, n, out_dtype, 0), want)
            for what, code in DEQUANT_FAULTS:
                bad = _dequant_raw(q, s, n, out_dtype, code)
                assert not torch.equal(bad, want), (what, rows, nb, n)
    # the serving cache's rows at a 4-byte offset: the first design
    buf = torch.randint(-127, 128, (16384 * 256 + 16,), generator=gen,
                        device="cuda").to(torch.int8)
    view = buf[4:4 + 16384 * 256].view(16384, 1, 256)
    s = torch.rand(16384, 1, 1, generator=gen, device="cuda")
    assert quant.dequant_plan(16384, 256, 1, 256, 1, 2,
                              view.data_ptr() % 16 == 0) == quant.SCALAR
    assert torch.equal(quant.dequantize_rows(view, s, 256, torch.bfloat16),
                       quant.dequantize_rows_plain(view, s, 256,
                                                   torch.bfloat16))
    taken[quant.SCALAR] += 1
    assert all(taken.values()), taken
    torch.cuda.synchronize()
    return taken


def _dequant_turns(q, s, n, out_dtype):
    """#15's first design and streaming body through the C function, in
    turns (first, vector, vector, first): {path: [device ms, ...]}."""
    times = {0: [], 1: []}
    for path in (0, 1, 1, 0):
        times[path].append(device_ms(
            lambda: _dequant_raw(q, s, n, out_dtype, path)))
    return times


# planted #14 faults: (what, path code of apex_quant8, on given scales)
QUANT_FAULTS = (("the absmax without the cell's last vector", 2, False),
                ("the neighbouring cell's given scale", 3, True))


def _quant_raw(x, block, path, scales=None):
    """#14 through its C function on ``path`` (0 the first design, 1 the
    streaming body, 2/3 QUANT_FAULTS), uncounted: (q, scales), the scales
    computed into a new tensor unless ``scales`` are given."""
    from apex_tpu_torch.kernels import quant
    rows, n = x.shape
    nb = -(-n // block)
    q = torch.empty((rows, nb, block), dtype=torch.int8, device=x.device)
    if scales is None:
        out = torch.empty((rows, nb, 1), dtype=torch.float32,
                          device=x.device)
        return quant._launch_quant(x, q, out, False, path)
    return quant._launch_quant(x, q, scales, True, path)


def _same_codes(a, b):
    """Two (codes, scales) pairs equal bit for bit, NaN scales (blocks
    with a non-finite value) in the same places."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[1].isnan(),
                                                    b[1].isnan())
            and torch.equal(a[1].nan_to_num(), b[1].nan_to_num()))


def _hold_quant(got, want):
    """(codes, scales) equal to the plain version's, bit for bit; a block
    with a NaN scale has it on both sides, and its codes (the plain
    version casts NaN quotients to int8) are not compared."""
    (q, s), (qp, sp) = got, want
    nan = sp.isnan()
    assert torch.equal(s.isnan(), nan)
    assert torch.equal(s[~nan], sp[~nan])
    keep = ~nan.expand_as(qp)
    assert torch.equal(q[keep], qp[keep])


def _quant_case(gen, rows, n, block, dtype, given):
    """x [rows, n] for the quantize checks: random, with an all-zero row,
    a block at scale 1.0 holding ties at k + .5 (the streaming body's
    division cases) and a NaN in row 2 where the rows allow; and the
    given scales (the plain version's, times 1.5) or None."""
    from apex_tpu_torch.kernels import quant
    x = _randn(gen, rows, n, dtype=dtype, scale=2.0)
    if rows > 2:
        x[0] = 0
        if n >= block:
            x[1, :block] = (torch.arange(block, device="cuda") % 20 - 9.5
                            ).to(dtype)
            x[1, 0] = 127
        x[2, min(5, n - 1)] = float("nan")
    scales = quant.quantize_rows_plain(x, block)[1] * 1.5 if given else None
    return x, scales


def _check_quant_plan(gen):
    """Every branch of ``quant_plan``, asserted, each held bit for bit to
    the plain version (a NaN block's NaN scale included), and every
    vector case also to the first design: computed and given scales, bf16
    and fp32, the serving store's admission and decode rows, blocks of 4
    to 1024 lanes (1 to 4 vectors a lane, 1 to 32 lanes a block), one-row
    calls with a ragged tail (a vector past n), GPT-2's bucket; the first
    design for ragged rows, blocks of 100, 2 and 2048 lanes and x at a
    4-byte offset. Both planted faults, each at the vector cases of its
    kind of scales where it should change 16 cells or more (the short
    absmax changes a cell whose max lies in its last vector: V / block of
    the cells, V = 8 bf16 or 4 fp32 values), must not be equal. Returns
    how many cases took each branch and how many faults were
    planted."""
    from apex_tpu_torch.kernels import quant
    taken = {quant.VECTOR: 0, quant.SCALAR: 0}
    planted = {code: 0 for _, code, _ in QUANT_FAULTS}
    cases = [(16384, 256, 256, torch.bfloat16, False),
             (BATCH, 256, 256, torch.bfloat16, False),
             (999, 512, 256, torch.float32, False),
             (1, 1000, 256, torch.float32, False),
             (1, 1001, 256, torch.bfloat16, False),
             (1000, 96, 32, torch.bfloat16, False),
             (100, 1024, 1024, torch.bfloat16, False),
             (100, 1024, 512, torch.float32, False),
             (300, 512, 128, torch.float32, False),
             (300, 64, 4, torch.float32, False),
             (1, GPT2_BUCKET_ROWS * 256, 256, torch.float32, True),
             (MLP_BUCKET_ROWS, 256, 256, torch.float32, True),
             (1, 1000, 256, torch.float32, True),
             (64, 256, 64, torch.bfloat16, True),
             (999, 300, 256, torch.float32, False),
             (64, 1000, 100, torch.float32, False),
             (40, 16, 2, torch.float32, False),
             (10, 4096, 2048, torch.bfloat16, False),
             (999, 300, 256, torch.float32, True)]
    for rows, n, block, dtype, given in cases:
        x, scales = _quant_case(gen, rows, n, block, dtype, given)
        nb = -(-n // block)
        path = quant.quant_plan(rows, n, nb, block, x.element_size(), True)
        got = quant.quantize_rows(x, block, scales)
        _hold_quant(got, quant.quantize_rows_plain(x, block, scales))
        taken[path] += 1
        if path != quant.VECTOR:
            continue
        assert _same_codes(_quant_raw(x, block, 0, scales), got), (rows, n)
        per_vector = 16 // x.element_size()
        for what, code, on_given in QUANT_FAULTS:
            if on_given == given and rows * nb * per_vector >= 16 * block:
                bad = _quant_raw(x, block, code, scales)
                assert not _same_codes(bad, got), (what, rows, n, block)
                planted[code] += 1
    # the admission rows at a 4-byte offset: the first design
    buf = _randn(gen, 16384 * 256 + 8, scale=2.0)
    view = buf[2:2 + 16384 * 256].view(16384, 256)
    assert quant.quant_plan(16384, 256, 1, 256, 2,
                            view.data_ptr() % 16 == 0) == quant.SCALAR
    _hold_quant(quant.quantize_rows(view, 256),
                quant.quantize_rows_plain(view, 256))
    taken[quant.SCALAR] += 1
    assert all(taken.values()) and all(planted.values()), (taken, planted)
    torch.cuda.synchronize()
    return taken, planted


def _quant_turns(x, block, scales=None):
    """#14's first design and streaming body through the C function, in
    turns (first, vector, vector, first): {path: [device ms, ...]}."""
    times = {0: [], 1: []}
    for path in (0, 1, 1, 0):
        times[path].append(device_ms(
            lambda: _quant_raw(x, block, path, scales)))
    return times


def _turns_text(times, second="vector"):
    return "; ".join(f"{'first' if k == 0 else second} "
                     f"{'/'.join(f'{t * 1e3:.2f}' for t in v)}"
                     for k, v in times.items())


def check_quant(gen):
    """#14 and #15 bit for bit against their plain versions: the serving
    path's [16384, 256] rows (8 slots x 2048 positions of one K or V
    leaf), one position per slot, ragged rows and blocks, fp32 and bf16,
    all-zero rows, ties at .5; each on every branch of its plan, its
    streaming body equal to its first design, two planted faults each,
    and the first designs timed beside them."""
    from apex_tpu_torch.kernels import quant
    from apex_tpu_torch.parallel import compression
    qtaken, planted = _check_quant_plan(gen)
    log(f"kernel quantize_int8: quant_plan's branches bit-identical to the "
        f"plain version ({qtaken[quant.VECTOR]} vector cases, each also "
        f"equal to the first design, {qtaken[quant.SCALAR]} first-design "
        f"cases incl. x at +4 bytes); planted faults not equal ("
        + "; ".join(f"{w}: {planted[c]} cases" for w, c, _ in QUANT_FAULTS)
        + ")")
    taken = _check_dequant_plan(gen)
    log(f"kernel dequantize_int8: dequant_plan's branches bit-identical to "
        f"the plain version ({taken[quant.VECTOR]} vector cases, each also "
        f"equal to the first design, {taken[quant.SCALAR]} first-design "
        f"cases incl. codes at +4 bytes); planted faults "
        f"({'; '.join(w for w, _ in DEQUANT_FAULTS)}) not equal")
    width = MODEL["num_query_groups"] * (
        MODEL["hidden_size"] // MODEL["num_attention_heads"])
    rows = BATCH * MODEL["max_position_embeddings"]
    cases = [(rows, width, 256, torch.bfloat16), (BATCH, width, 256,
                                                  torch.bfloat16),
             (rows, width, 256, torch.float32), (999, 300, 256,
                                                 torch.float32),
             (1000, 100, 32, torch.bfloat16), (7, 1, 256, torch.float32),
             (64, 1000, 100, torch.float32)]
    for r, n, block, dtype in cases:
        x = _randn(gen, r, n, dtype=dtype, scale=2.0)
        x[0] = 0  # an all-zero row
        if n >= 256 and r > 1:  # a block with scale 1.0 and ties at k + .5
            x[1, :block] = (torch.arange(block, device="cuda") % 20 - 9.5
                            ).to(dtype)
            x[1, 0] = 127
        q, s = quant.quantize_rows(x, block)
        qp, sp = quant.quantize_rows_plain(x, block)
        torch.cuda.synchronize()
        assert torch.equal(q, qp) and torch.equal(s, sp), (r, n, block, dtype)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = quant.dequantize_rows(q, s, n, out_dtype)
            want = quant.dequantize_rows_plain(q, s, n, out_dtype)
            assert torch.equal(got, want), (r, n, block, out_dtype)
    flat = _randn(gen, 1000, dtype=torch.float32)
    q, s = compression.quantize_blockwise(flat)
    assert torch.equal(compression.dequantize_blockwise(q, s, 1000),
                       quant.dequantize_rows_plain(q[None], s[None], 1000)[0])
    torch.cuda.synchronize()
    log("kernels: quantize_int8 and dequantize_int8 bit-identical to their "
        f"plain versions on {len(cases)} shapes (ragged rows and blocks, "
        "fp32 and bf16 in and out, zero rows, ties at .5)")

    # the path's calls: admission (every position of a leaf, bf16 in) and
    # the decode step's read (bf16 out); one position per slot per step
    x = _randn(gen, rows, width, scale=2.0)
    q, s = quant.quantize_rows(x, 256)
    qp, sp = quant.quantize_rows_plain(x, 256)
    qbytes = _quant_bytes(rows, width, 256, 2)
    assert quant.quant_plan(rows, width, 1, 256, 2, True) == quant.VECTOR
    qturns = _quant_turns(x, 256)
    entries = [entry(
        "quantize_int8", f"x[{rows},{width}] bf16 -> int8 + fp32 scales "
        "(admission, one K or V leaf)", q, qp, "bit-identical",
        lambda: quant.quantize_rows(x, 256),
        lambda: quant.quantize_rows_plain(x, 256), None,
        bound(qbytes, 4 * rows * width, FP32_OPS_PER_S))]
    assert entries[0]["max_abs_err"] == 0 and torch.equal(s, sp)
    entries[0]["first_design_ms"] = statistics.median(qturns[0])
    got = quant.dequantize_rows(q, s, width, torch.bfloat16)
    want = quant.dequantize_rows_plain(q, s, width, torch.bfloat16)
    assert quant.dequant_plan(rows, width, 1, 256, 1, 2, True) == quant.VECTOR
    turns = _dequant_turns(q, s, width, torch.bfloat16)
    entries.append(entry(
        "dequantize_int8", f"q[{rows},1,256] int8 + scales -> bf16 (decode "
        "read, one K or V leaf)", got, want, "bit-identical",
        lambda: quant.dequantize_rows(q, s, width, torch.bfloat16),
        lambda: quant.dequantize_rows_plain(q, s, width, torch.bfloat16),
        None, bound(qbytes, rows * width, FP32_OPS_PER_S)))
    assert entries[1]["max_abs_err"] == 0
    entries[1]["first_design_ms"] = statistics.median(turns[0])
    # off the entries: one position per slot, and the fp32 output
    xs = _randn(gen, BATCH, width, scale=2.0)
    small = device_ms(lambda: quant.quantize_rows(xs, 256))
    small_turns = _quant_turns(xs, 256)
    fp32_ms = device_ms(lambda: quant.dequantize_rows(q, s, width))
    fp32_turns = _dequant_turns(q, s, width, torch.float32)
    small_bound = _quant_bytes(BATCH, width, 256, 2) / HBM_BYTES_PER_S
    fp32_bound = _quant_bytes(rows, width, 256, 4) / HBM_BYTES_PER_S
    log(f"kernel quantize_int8 at one position per slot [{BATCH},{width}] "
        f"(decode step): {_us(small)} on the device, bound "
        f"{small_bound * 1e6:.4f} us; dequantize_int8 to fp32 "
        f"[{rows},{width}]: {_us(fp32_ms)}, bound {fp32_bound * 1e6:.3f} us")
    log(f"kernel dequantize_int8 [{rows},1,256] int8 through the C function "
        f"in turns (us; first design, then the streaming body): to bf16 "
        + _turns_text(turns) + "; to fp32 " + _turns_text(fp32_turns))
    log(f"kernel quantize_int8 through the C function in turns (us; first "
        f"design, then the streaming body): [{rows},{width}] bf16 "
        + _turns_text(qturns) + f"; [{BATCH},{width}] bf16 "
        + _turns_text(small_turns))
    return entries


# GPT-2 345M's largest gradient bucket (the 51.5 M-element embedding and
# head, alone in a bucket of 10 M), bench.py ddp_compressed's MLP bucket
# (4 x 1024 x 1024 + 4 x 1024 = 4,198,400 elements) and GPT-2's flat
# parameter vector (406,382,592 elements, the ZeRO gather), in blocks of
# 256
GPT2_BUCKET_ROWS, MLP_BUCKET_ROWS, GPT2_FLAT_ROWS = 201216, 16400, 1587432


def _int4_scales(x2d, with_gmax=False):
    """The local two-level effective scales [nb, 1] of x2d (and gmax)."""
    from apex_tpu_torch.kernels import quant4
    s, _, gmax = quant4.two_level_scales(quant4.block_absmax(x2d))
    return (s, gmax) if with_gmax else s


def _int4_error(x2d, y2d, s, gmax):
    """Hold the int4 error to half a step of the local grid: s_eff / 2
    where the code is not clipped at +-7 (|x| <= 7.5 s_eff), and half a
    level-1 step, gmax / 510, where it is (a block whose sq rounded down
    leaves its absmax past 7 s_eff). Returns (largest error / s_eff on the
    unclipped lanes, share of clipped lanes)."""
    err = (y2d - x2d).abs()
    s = s.expand_as(err)
    clipped = x2d.abs() > 7.5 * s
    ratio = (err / s)[~clipped].max().item() if (~clipped).any() else 0.0
    assert ratio <= 0.5 * (1 + 2 ** -20), ratio
    assert (err[clipped] <= gmax / 510 * (1 + 1e-5)).all()
    return ratio, clipped.float().mean().item()


def check_quant4(gen):
    """#16-#19 and the fused #23/#24 bit for bit against their plain
    versions at GPT-2's largest bucket and the MLP's bucket, and off the
    path: an odd block width, all-zero blocks, one row, unpack's ``n``;
    #23/#24 also at GPT-2's flat parameter vector (the int4 gather); #14
    with given scales and #15 on int32 totals at the GPT-2 bucket (the
    data-parallel routes of the int8 kernels)."""
    from apex_tpu_torch.kernels import quant, quant4
    cases = [(GPT2_BUCKET_ROWS, 256), (MLP_BUCKET_ROWS, 256), (1000, 33),
             (1, 256), (1, 7), (77, 2), (300, 100)]
    for nb, b in cases:
        x = _randn(gen, nb, b, dtype=torch.float32, scale=1e-3)
        if nb > 2:
            x[1] = 0  # an all-zero block
            x[2] *= 1e-9  # a block whose sq clips up to 1
        s, gmax = _int4_scales(x, with_gmax=True)
        q = quant4.quantize_int4(x, s)
        qp = quant4.quantize_int4_plain(x, s)
        y = quant4.dequantize_int4(q, s)
        p = quant4.pack_int4(q)
        u = quant4.unpack_int4(p, b)
        u_full = quant4.unpack_int4(p)
        pf = quant4.quantize_pack_int4(x, s)
        yf = quant4.unpack_dequantize_int4(pf, s, b)
        torch.cuda.synchronize()
        assert torch.equal(q, qp), (nb, b)
        assert torch.equal(pf, p) and torch.equal(
            pf, quant4.quantize_pack_int4_plain(x, s)), (nb, b)
        assert torch.equal(yf, y) and torch.equal(
            quant4.unpack_dequantize_int4(pf, s),
            quant4.unpack_dequantize_int4_plain(pf, s)), (nb, b)
        assert torch.equal(y, quant4.dequantize_int4_plain(q, s)), (nb, b)
        assert torch.equal(p, quant4.pack_int4_plain(q)), (nb, b)
        assert torch.equal(u, q) and torch.equal(
            u_full, quant4.unpack_int4_plain(p)), (nb, b)
        _int4_error(x, y, s, gmax)
    # the data-parallel routes of #14 and #15 at the GPT-2 bucket: codes on
    # given (shared) scales, one row of nb blocks, and int32 totals
    nb = GPT2_BUCKET_ROWS
    x = _randn(gen, 1, nb * 256, dtype=torch.float32, scale=1e-3)
    shared = quant.block_scales(x.reshape(1, nb, 256)) * 1.5
    q8, s8 = quant.quantize_rows(x, 256, shared)
    assert s8 is shared
    assert torch.equal(q8, quant.quantize_rows_plain(x, 256, shared)[0])
    totals = q8.int() * 3 - 100  # a sum over ranks: beyond int8's range
    got = quant.dequantize_rows(totals, shared)
    assert torch.equal(got, quant.dequantize_rows_plain(totals, shared))
    assert quant.quant_plan(1, nb * 256, nb, 256, 4, True) == quant.VECTOR
    given_turns = _quant_turns(x, 256, shared)
    given_ms = device_ms(lambda: quant.quantize_rows(x, 256, shared))
    given_plain = device_ms(lambda: quant.quantize_rows_plain(x, 256, shared),
                            iters=5)
    i32_ms = device_ms(lambda: quant.dequantize_rows(totals, shared))
    i32_plain = device_ms(lambda: quant.dequantize_rows_plain(totals, shared),
                          iters=5)
    assert quant.dequant_plan(1, nb * 256, nb, 256, 4, 4, True) == quant.VECTOR
    i32_turns = _dequant_turns(totals, shared, nb * 256, torch.float32)
    n = nb * 256
    log(f"kernels: quantize_int4, dequantize_int4, pack_int4, unpack_int4, "
        f"quantize_pack_int4, unpack_dequantize_int4 bit-identical to their "
        f"plain versions (and the fused pair to the unfused) on {len(cases)} "
        f"shapes "
        f"(odd and even widths, zero and clipped blocks, one row); "
        f"quantize_int8 on given scales and dequantize_int8 on int32 totals "
        f"bit-identical at [{nb},256]")
    log(f"kernel quantize_int8 given scales [{nb},256] fp32: "
        f"{_us(given_ms)} on the device, plain {_us(given_plain)}, bound "
        f"{(n * 5 + nb * 4) / HBM_BYTES_PER_S * 1e6:.3f} us; through the C "
        f"function in turns (us): " + _turns_text(given_turns)
        + "; dequantize_int8"
        f" int32 totals: {_us(i32_ms)}, plain {_us(i32_plain)}, bound "
        f"{(n * 8 + nb * 4) / HBM_BYTES_PER_S * 1e6:.3f} us; through the C "
        f"function in turns (us): first design "
        f"{'/'.join(f'{t * 1e3:.2f}' for t in i32_turns[0])}, streaming "
        f"body {'/'.join(f'{t * 1e3:.2f}' for t in i32_turns[1])}")
    del x, q8, totals, got

    # the entries: GPT-2's largest bucket
    x = _randn(gen, nb, 256, dtype=torch.float32, scale=1e-3)
    s = _int4_scales(x)
    q = quant4.quantize_int4(x, s)
    p = quant4.pack_int4(q)
    ops = 4 * n  # a division, a rounding, two clips a lane
    wide = n * 4 + n + nb * 4  # fp32 lanes, int8 codes, fp32 scales
    narrow = n + n // 2  # int8 codes, packed bytes
    shape = f"[{nb},256] (GPT-2's 51.5 M-element bucket)"
    entries = [
        entry("quantize_int4", shape + " fp32 -> int8", q,
              quant4.quantize_int4_plain(x, s), "bit-identical",
              lambda: quant4.quantize_int4(x, s),
              lambda: quant4.quantize_int4_plain(x, s), None,
              bound(wide, ops, FP32_OPS_PER_S)),
        entry("dequantize_int4", shape + " int8 -> fp32",
              quant4.dequantize_int4(q, s),
              quant4.dequantize_int4_plain(q, s), "bit-identical",
              lambda: quant4.dequantize_int4(q, s),
              lambda: quant4.dequantize_int4_plain(q, s), None,
              bound(wide, n, FP32_OPS_PER_S)),
        entry("pack_int4", shape + " int8 -> uint8 [.,128]", p,
              quant4.pack_int4_plain(q), "bit-identical",
              lambda: quant4.pack_int4(q),
              lambda: quant4.pack_int4_plain(q), None,
              bound(narrow, 0, FP32_OPS_PER_S)),
        entry("unpack_int4", shape + " uint8 [.,128] -> int8",
              quant4.unpack_int4(p), quant4.unpack_int4_plain(p),
              "bit-identical", lambda: quant4.unpack_int4(p),
              lambda: quant4.unpack_int4_plain(p), None,
              bound(narrow, 0, FP32_OPS_PER_S))]
    del x, s, q, p
    # the fused pair at GPT-2's flat parameter vector, the int4 gather's
    nf = GPT2_FLAT_ROWS * 256
    x = _randn(gen, GPT2_FLAT_ROWS, 256, dtype=torch.float32, scale=1e-2)
    s = _int4_scales(x)
    p = quant4.quantize_pack_int4(x, s)
    fused = nf * 4 + nf // 2 + GPT2_FLAT_ROWS * 4  # fp32, nibbles, scales
    shape = f"[{GPT2_FLAT_ROWS},256] (GPT-2's flat parameter vector)"
    entries += [
        entry("quantize_pack_int4", shape + " fp32 -> uint8 [.,128]", p,
              quant4.quantize_pack_int4_plain(x, s), "bit-identical",
              lambda: quant4.quantize_pack_int4(x, s),
              lambda: quant4.quantize_pack_int4_plain(x, s), None,
              bound(fused, 4 * nf, FP32_OPS_PER_S)),
        entry("unpack_dequantize_int4", shape + " uint8 [.,128] -> fp32",
              quant4.unpack_dequantize_int4(p, s),
              quant4.unpack_dequantize_int4_plain(p, s), "bit-identical",
              lambda: quant4.unpack_dequantize_int4(p, s),
              lambda: quant4.unpack_dequantize_int4_plain(p, s), None,
              bound(fused, nf, FP32_OPS_PER_S))]
    del x, s, p
    assert all(e["max_abs_err"] == 0 for e in entries), entries
    xm = _randn(gen, MLP_BUCKET_ROWS, 256, dtype=torch.float32, scale=1e-3)
    sm = _int4_scales(xm)
    mlp_ms = device_ms(lambda: quant4.quantize_int4(xm, sm))
    mlp_bound = (MLP_BUCKET_ROWS * 256 * 5 + MLP_BUCKET_ROWS * 4) \
        / HBM_BYTES_PER_S
    log(f"kernel quantize_int4 at the MLP bucket [{MLP_BUCKET_ROWS},256]: "
        f"{_us(mlp_ms)} on the device, bound {mlp_bound * 1e6:.3f} us")
    return entries


def _gemm_ratio(got, want, mag):
    """Largest |got - want| / (|x| @ |w|) over the elements."""
    return ((got.float() - want.float()).abs()
            / mag.clamp_min(1e-30)).max().item()


def _tp_matmul_raw(x2, w, k, splits=None):
    """Kernel #20 launched on fp32 x2 [m, >= k] and w [>= k, n] with the
    contraction cut to k (its first k columns and rows), through its
    launch plan for (m, n, k) (S forced to ``splits`` where given),
    uncounted: for the planted faults and the forced split counts."""
    from apex_tpu_torch.kernels import fused_cc
    out = torch.empty(x2.shape[0], w.shape[1], device="cuda")
    return fused_cc.mm_launch(x2, w, out, k, splits)


def check_tp_matmul(gen):
    """#20 at the row-parallel tiles of both TP paths, each x against the
    second column tile of the full wo (a strided view read in place):
    GPT-2 345M's (``tp_gpt2``: x [8192, 4096] and [8192, 1024] fp32, 256
    of wo's 1024 columns) and ``bench.py tp_dp``'s (x [128, 1024] and
    [128, 256], 64 of 256 columns: split K). Each tile's launch plan is
    logged; each is held to TP_MATMUL_TOL of |x| @ |w| per element, on
    its plan and with S forced to 1 and to the most splits, and two runs
    must agree bit for bit (the fixed merge order); planted faults (the
    last 16 K terms skipped, the tile's columns shifted by one, both
    through the kernel's own launch on its plan) must read past that
    limit. Off the path: rows not a multiple of 8 and one row, N not a
    multiple of the block tile, K not a multiple of the K step, bf16 x,
    bf16 w, a 3-D x, rows of x apart by more than K, a strided w view off
    a 16-byte boundary, ragged rows and N unsplit."""
    from apex_tpu_torch.kernels import fused_cc, registry
    entries, honest, faults = [], [], []
    tiles = []  # each path's MLP wo tile first, then its attention wo's
    for path, model, batch in (("tp_gpt2", TP_GPT2_MODEL, TP_GPT2_BATCH),
                               ("tp_dp", TP_DP_MODEL, TP_DP_BATCH)):
        rows, h = batch * model["max_seq"], model["hidden"]
        tiles += [(f"{path} mlp wo", rows, 4 * h, h),
                  (f"{path} attn wo", rows, h, h)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for label, m, k, width in tiles:
        n = width // fused_cc.DEFAULT_TILES
        x = _randn(gen, m, k, dtype=torch.float32)
        w_full = _randn(gen, k, width, dtype=torch.float32, scale=k ** -0.5)
        w = w_full[:, n:2 * n]
        mag = torch.matmul(x.abs(), w.abs())
        bm, bn, splits = fused_cc.plan(m, n, k, sms)
        plans.append(f"{label} [{m}, {k}] x [{k}, {n}]: {bm} x {bn} tiles, "
                     f"S = {splits}, "
                     f"{-(-m // bm) * -(-n // bn) * splits} blocks")
        before = registry.launches()["tp_matmul"]
        got = fused_cc._matmul(x, w)
        assert registry.launches()["tp_matmul"] == before + 1
        want = fused_cc.matmul_plain(x, w)
        again = fused_cc._matmul(x, w)
        torch.cuda.synchronize()
        # the splits merge in a fixed order: two runs agree bit for bit
        assert torch.equal(got, again), label
        honest.append(_gemm_ratio(got, want, mag))
        # the other split counts through the same C function: one (no
        # scratch) and the most the K steps allow
        for forced in {1, min(fused_cc.MM_MAX_SPLITS,
                              -(-k // fused_cc.MM_STEP))} - {splits}:
            honest.append(_gemm_ratio(_tp_matmul_raw(x, w, k, forced),
                                      want, mag))
        faults.append((f"{label}: last 16 K terms skipped", _gemm_ratio(
            _tp_matmul_raw(x, w, k - 16), want, mag)))
        faults.append((f"{label}: tile columns shifted by one", _gemm_ratio(
            _tp_matmul_raw(x, w_full[:, n + 1:2 * n + 1], k), want, mag)))
        entries.append(entry(
            "tp_matmul", f"{label} tile [{m}, {k}] x [{k}, {n}] of "
            f"[{k}, {width}] fp32", got, want,
            f"per element <= {TP_MATMUL_TOL} * (|x| @ |w|); read "
            f"{honest[-1]:.3e}",
            lambda: fused_cc._matmul(x, w),
            lambda: fused_cc.matmul_plain(x, w), lambda: torch.matmul(x, w),
            bound(4 * (m * k + k * n + m * n), 2 * m * n * k,
                  FP32_OPS_PER_S)))
        del x, w_full, w, mag, got, want
    log("kernel tp_matmul launch plans on this card's {sms} SMs: "
        .format(sms=sms) + "; ".join(plans))
    log(f"kernel tp_matmul: path tiles read {max(honest):.3e} of |x| @ |w| "
        f"(limit {TP_MATMUL_TOL}; also at S = 1 and the most splits; two "
        f"runs bit-identical at each tile); planted faults: "
        + "; ".join(f"{name} {r:.3e}" for name, r in faults))
    assert max(honest) <= TP_MATMUL_TOL, honest
    assert all(r > TP_MATMUL_TOL for _, r in faults), faults

    def f32(*shape, dtype=torch.float32):
        return _randn(gen, *shape, dtype=dtype)

    wide = f32(256, 300)
    cases = [("13 rows", f32(13, 256), f32(256, 64)),
             ("one row", f32(1, 1024), f32(1024, 1024)[:, 256:512]),
             ("N 100", f32(300, 128), f32(128, 100)),
             ("K 1000", f32(256, 1000), f32(1000, 128)),
             ("bf16 x", f32(512, 1024, dtype=torch.bfloat16),
              f32(1024, 1024)[:, :256]),
             ("bf16 x and w", f32(64, 512, dtype=torch.bfloat16),
              f32(512, 96, dtype=torch.bfloat16)),
             ("bf16 w", f32(64, 512), f32(512, 96, dtype=torch.bfloat16)),
             ("3-D x", f32(4, 33, 256), f32(256, 64)),
             ("x rows 512 apart, K 256", f32(64, 512)[:, :256],
              f32(256, 80)),
             ("rows 8200, N 1000 (S = 1)", f32(8200, 256), f32(256, 1000)),
             ("w view off 16 bytes", f32(130, 256), wide[:, 3:203])]
    for label, x, w in cases:
        got = fused_cc._matmul(x, w)
        want = fused_cc.matmul_plain(x, w)
        ref = torch.matmul(x.float(), w.float())  # want before its cast
        mag = torch.matmul(x.float().abs(), w.float().abs())
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape, label
        total = got
        if got.dtype == torch.bfloat16:
            total = fused_cc._matmul(x.float(), w.float())
            assert torch.equal(got, total.to(torch.bfloat16)), label
        over = ((total - ref).abs() - mag * TP_MATMUL_TOL).max().item()
        assert over <= 0, (label, over)
        log(f"kernel tp_matmul {label} {tuple(x.shape)} x {tuple(w.shape)}"
            f" -> {got.dtype}: {_gemm_ratio(total, ref, mag):.3e} of "
            f"|x| @ |w| (within the limit)"
            + ("; the bf16 output is its fp32 sum rounded to nearest, bit "
               "for bit" if total is not got else ""))
    return entries


def _verify_inputs(gen, b, g, rep, d, T, block, w):
    """q [w, b, g, rep, d] bf16 and the int8 store's codes and scales of
    random K/V rows, quantized by the plain version."""
    from apex_tpu_torch.kernels import quant
    nb = -(-(g * d) // block)

    def store():
        x = _randn(gen, T * b, g * d, dtype=torch.float32)
        q, s = quant.quantize_rows_plain(x, block)
        return q.reshape(T, b, nb, block), s.reshape(T, b, nb, 1)

    kq, ks = store()
    vq, vs = store()
    return _randn(gen, w, b, g, rep, d), kq, ks, vq, vs


# planted #22 faults of the split body: (what, path code of
# apex_spec_verify)
VERIFY_FAULTS = (("the last live split left out of the merge", 2),
                 ("each score on its neighbour key row's scale", 3))


def _verify_raw(q, kq, ks, vq, vs, starts, path, splits=None):
    """#22 through its C function on ``path`` (0 the first design, 1 the
    split body, 2/3 VERIFY_FAULTS) over batched operands, uncounted; S
    forced to ``splits`` where given."""
    from apex_tpu_torch.kernels import fused_cc
    return fused_cc._launch_verify(q, kq, ks, vq, vs, starts,
                                   q.shape[-1] ** -0.5, path, splits)


def _at_plus4_int8(t):
    """A contiguous copy of the int8 ``t`` whose data starts 4 bytes past
    a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=torch.int8, device=t.device)
    view = buf[4:4 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


def check_spec_verify(gen):
    """#22 against its plain version (dequantize, then the window
    attention) on every branch of ``verify_plan``: the split tensor-core
    body for bf16 q where a cell's lanes lie in one block (blocks of 256,
    128 and 64 = d lanes, head dims 64 and 128, padding lanes past g * d),
    each twice and bit-identical, also at forced splits 1 and 16; the
    first design for a block of 96 whose cells cross blocks, fp32
    queries and codes at a 4-byte offset; the JAX one-slot signature.
    Then the TinyLlama verify window over a full-length int8 store, each
    slot at its own start: the split body twice bit-identical, at S 1,
    the planned S and 16, both planted faults past ATTN_TOL, and the
    first design timed beside it in turns."""
    from apex_tpu_torch.kernels import fused_cc, kv_attention, registry
    n, g = MODEL["num_attention_heads"], MODEL["num_query_groups"]
    d, rep, T = MODEL["hidden_size"] // n, n // g, MODEL[
        "max_position_embeddings"]
    w = SPEC_K + 1
    taken = {fused_cc.VERIFY_SPLIT: 0, fused_cc.VERIFY_FIRST_DESIGN: 0}
    before = registry.launches()["spec_verify"]
    calls = before  # the count once every wrapper call below has run
    for gg, rr, dd, block, dtype, offset in (
            (2, 4, 64, 96, torch.bfloat16, False),
            (2, 2, 128, 256, torch.bfloat16, False),
            (4, 8, 64, 256, torch.float32, False),
            (2, 4, 64, 128, torch.bfloat16, False),
            (4, 8, 64, 64, torch.bfloat16, False),
            (3, 2, 64, 256, torch.bfloat16, False),
            (4, 8, 64, 256, torch.bfloat16, True)):
        starts = _mixed_offsets(3, 1000 - w, gen)
        q, kq, ks, vq, vs = _verify_inputs(gen, 3, gg, rr, dd, 1000, block,
                                           w)
        q = q.to(dtype)
        if offset:
            kq, vq = _at_plus4_int8(kq), _at_plus4_int8(vq)
        path = fused_cc.verify_plan(q.element_size(), dd, block,
                                    not offset)
        taken[path] += 1
        got = fused_cc.spec_verify_attention(q, kq, ks, vq, vs, starts,
                                             dd ** -0.5)
        calls += 1
        want = fused_cc.spec_verify_reference(q, kq, ks, vq, vs, starts,
                                              dd ** -0.5)
        torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        if path == fused_cc.VERIFY_SPLIT:
            assert torch.equal(fused_cc.spec_verify_attention(
                q, kq, ks, vq, vs, starts, dd ** -0.5), got), (gg, dd)
            calls += 1
            for splits in (1, kv_attention.MAX_SPLITS):
                torch.testing.assert_close(
                    _verify_raw(q, kq, ks, vq, vs, starts, path, splits),
                    want, rtol=ATTN_TOL, atol=ATTN_TOL)
        if offset:
            continue
        one = fused_cc.spec_verify_attention(
            q[:, 1].contiguous(), kq[:, 1].contiguous(),
            ks[:, 1].contiguous(), vq[:, 1].contiguous(),
            vs[:, 1].contiguous(), int(starts[1]), dd ** -0.5)
        torch.testing.assert_close(one, want[:, 1], rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
        calls += 1
    assert all(taken.values()), taken
    torch.cuda.synchronize()
    starts = torch.tensor([0, 100, 300, 700, 1100, 1500, 1900, T - w],
                          dtype=torch.int32, device="cuda")
    q, kq, ks, vq, vs = _verify_inputs(gen, BATCH, g, rep, d, T, 256, w)
    sm = d ** -0.5
    assert fused_cc.verify_plan(2, d, 256, True) == fused_cc.VERIFY_SPLIT
    got = fused_cc.spec_verify_attention(q, kq, ks, vq, vs, starts, sm)
    want = fused_cc.spec_verify_reference(q, kq, ks, vq, vs, starts, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert torch.equal(
        fused_cc.spec_verify_attention(q, kq, ks, vq, vs, starts, sm), got)
    calls += 2
    planned = kv_attention.plan(w * rep, BATCH * g,
                                kv_attention.sm_count(0))[1]
    forced = {}
    for splits in sorted({1, planned, kv_attention.MAX_SPLITS}):
        out = _verify_raw(q, kq, ks, vq, vs, starts, fused_cc.VERIFY_SPLIT,
                          splits)
        torch.testing.assert_close(out, want, rtol=ATTN_TOL, atol=ATTN_TOL)
        forced[splits] = max_abs(out, want)
    faults = {what: max_abs(_verify_raw(q, kq, ks, vq, vs, starts, code),
                            want) for what, code in VERIFY_FAULTS}
    assert all(e > ATTN_TOL for e in faults.values()), faults
    turns = {0: [], 1: []}
    for path in (0, 1, 1, 0):
        turns[path].append(device_ms(
            lambda: _verify_raw(q, kq, ks, vq, vs, starts, path)))
    # the wrapper counts its calls alone, not the raw launches
    assert registry.launches()["spec_verify"] == calls, (calls, before)
    log(f"kernel spec_verify: verify_plan's branches within {ATTN_TOL} of "
        f"the plain version ({taken[fused_cc.VERIFY_SPLIT]} split cases, "
        f"each twice bit-identical and at S 1 and 16; "
        f"{taken[fused_cc.VERIFY_FIRST_DESIGN]} first-design cases incl. "
        f"codes at +4 bytes); at the verify window: two runs bit-identical, "
        f"S " + ", ".join(f"{k} {v:.3e}" for k, v in forced.items())
        + f" (planned {planned}); planted faults "
        + "; ".join(f"{k}: max abs err {v:.3e} ({v / ATTN_TOL:.1f}x "
                    f"ATTN_TOL)" for k, v in faults.items())
        + "; through the C function in turns (us): "
        + _turns_text(turns, "split"))
    live = int((starts + w).sum())  # cache rows each slot reads
    keys = sum(int(st) * w + w * (w + 1) // 2 for st in starts.tolist())
    nbytes = (q.numel() * 2 + 2 * live * (256 + 4)  # codes + scales, K and V
              + got.numel() * 4)
    result = entry(
        "spec_verify", f"q[{w},{BATCH},{g},{rep},{d}] bf16, int8 store "
        f"[{T},{BATCH},1,256], starts {starts.tolist()}", got, want,
        f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: fused_cc.spec_verify_attention(q, kq, ks, vq, vs, starts,
                                               sm),
        lambda: fused_cc.spec_verify_reference(q, kq, ks, vq, vs, starts,
                                               sm), None,
        bound(nbytes, 4 * d * g * rep * keys, BF16_TENSOR_OPS_PER_S))
    result["first_design_ms"] = statistics.median(turns[0])
    return [result]


def _latent_cache(gen, T, b, L, filled, dtype=torch.bfloat16):
    """A latent cache [T, b, L] with rows [0, filled) written and the
    rest zero, as the model leaves it."""
    cache = torch.zeros(T, b, L, dtype=dtype, device="cuda")
    cache[:filled] = _randn(gen, filled, b, L, dtype=dtype)
    return cache


def _mla_bound(b, n, L, lat, lengths):
    """The MLA decode's least time: q, the live rows of each batch row
    and the fp32 output moved once, against the products on the tensor
    cores by the cheaper exact route: the scores as one bf16 term (2*n*L
    a live row), P . C as three (p is fp32: 3*2*n*lat)."""
    live = sum(lengths)
    nbytes = b * n * L * 2 + live * L * 2 + b * n * lat * 4
    return bound(nbytes, 2 * n * (L + 3 * lat) * live, BF16_TENSOR_OPS_PER_S)


def _mla_bound_fp32(b, n, L, lat, lengths):
    """The earlier bound: 2*n*(L + lat) operations a live row as fp32 FMAs
    (p stays fp32, as in the TPU kernel), against the same bytes."""
    live = sum(lengths)
    nbytes = b * n * L * 2 + live * L * 2 + b * n * lat * 4
    return bound(nbytes, 2 * n * (L + lat) * live, FP32_OPS_PER_S)


# planted #26 faults of the tensor-core body: (what, path code of
# apex_mla_decode)
MLA_KERNEL_FAULTS = (("the last live split dropped in the merge", 2),
                     ("the rope columns left out of the scores", 3))


def _mla_raw(q, cache, lengths, lat, scale, path, **sizes):
    """#26 through its C function on ``path`` (0 the first design, 1 the
    tensor-core body, 2/3 MLA_KERNEL_FAULTS), uncounted, ``lengths`` an
    int32 [b] tensor on the card; ``sizes`` override the plan's (splits,
    min_steps)."""
    from apex_tpu_torch.contrib import mla_decode
    from apex_tpu_torch.kernels import kv_attention
    plan = mla_decode.plan_for(q, cache, lat)
    if path == mla_decode.FIRST_DESIGN and plan.path != path:
        chunk, splits = mla_decode.split_rows(
            cache.shape[0], q.shape[0], q.shape[1],
            kv_attention.sm_count(q.device.index or 0))
        plan = plan._replace(chunk=chunk, splits=splits)
    return mla_decode._launch(q, cache, lengths, lat, scale,
                              plan._replace(**sizes), path)


def _rows(b, length):
    return torch.full((b,), length, dtype=torch.int32, device="cuda")


def _mla_design_and_faults(label, q, cache, length, lat, scale):
    """At one path shape, through #26's C function (uncounted): both
    planted faults held to the plain version (each must read past
    MLA_TOL), then the first design and the tensor-core body in turns
    (first, tensor cores, tensor cores, first). Returns the first design's
    median device ms."""
    from apex_tpu_torch.contrib import mla_decode
    from apex_tpu_torch.kernels import registry
    before = registry.launches()
    b = q.shape[0]
    lengths = _rows(b, length)
    want = mla_decode.mla_decode_reference(q, cache, length, lat, scale)
    errs = {what: max_abs(_mla_raw(q, cache, lengths, lat, scale, code), want)
            for what, code in MLA_KERNEL_FAULTS}
    assert all(e > MLA_TOL for e in errs.values()), (label, errs)
    times = {0: [], 1: []}
    for path in (0, 1, 1, 0):
        times[path].append(device_ms(
            lambda: _mla_raw(q, cache, lengths, lat, scale, path)))
    assert registry.launches() == before  # the raw launches are uncounted
    log(f"kernel mla_decode {label} (length {length}): planted faults "
        + "; ".join(f"{k}: max abs err {v:.3e} ({v / MLA_TOL:.1f}x MLA_TOL)"
                    for k, v in errs.items())
        + "; through the C function in turns (us): first design "
        f"{'/'.join(f'{t * 1e3:.2f}' for t in times[0])}, tensor cores "
        f"{'/'.join(f'{t * 1e3:.2f}' for t in times[1])}")
    return statistics.median(times[0])


def _mla_split_sweep(label, q, cache, length, lat, scale):
    """The tensor-core body's device time at the grid's S splits and the
    minimum split length (16-key steps) around the plan's: the
    measurement behind mla_decode.MAX_SPLITS and MIN_SPLIT_STEPS."""
    from apex_tpu_torch.contrib import mla_decode
    lengths = _rows(q.shape[0], length)
    res = {}
    for splits in (8, 12, 16):
        for steps in (1, 2, 4, 8):
            res[splits, steps] = device_ms(lambda: _mla_raw(
                q, cache, lengths, lat, scale, mla_decode.TENSOR_CORES,
                splits=splits, min_steps=steps))
    plan = mla_decode.plan_for(q, cache, lat)
    log(f"kernel mla_decode {label} (length {length}) split sweep (us; S "
        f"splits x minimum steps; the plan takes S {plan.splits}, "
        f"{plan.min_steps}): "
        + "; ".join(f"S{k[0]}/{k[1]} {v * 1e3:.2f}" for k, v in res.items()))


def check_mla_decode(gen):
    """#26 on every branch of ``mla_plan`` it can run (tensor cores for
    bf16 q and cache at L a multiple of 64 and lat 512; the first design
    for fp32 q or cache, another lat, L not a multiple of 64, rows whose
    stages overflow shared memory; q or cache off a 16-byte boundary is
    refused, check_refusals), each branch asserted and held to the plain
    version within MLA_TOL; the tensor-core body run twice bit-identical;
    at both path shapes its two planted faults and the first design timed
    beside it, and the split sweep."""
    from apex_tpu_torch.contrib import mla_decode
    cfg = MLA_DECODE_CFG
    n, lat = cfg["num_heads"], cfg["kv_lora_rank"]
    L = lat + cfg["qk_rope_head_dim"]
    T, b = cfg["max_decode_length"], MLA_BATCH
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    taken = {mla_decode.FIRST_DESIGN: 0, mla_decode.TENSOR_CORES: 0}

    def held(q, cache, length, lat=lat, scale=scale, path=None):
        plan = mla_decode.plan_for(q, cache, lat)
        if path is not None:
            assert plan.path == path, (plan, tuple(q.shape), q.dtype,
                                       cache.dtype, lat)
        taken[plan.path] += 1
        got = mla_decode.mla_flash_decode(q, cache, length, lat, scale)
        want = mla_decode.mla_decode_reference(q, cache, length, lat, scale)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (
            q.shape[0], q.shape[1], lat)
        torch.testing.assert_close(got, want, rtol=MLA_TOL, atol=MLA_TOL)
        return got, want

    tc, first = mla_decode.TENSOR_CORES, mla_decode.FIRST_DESIGN
    # the path's shapes: bf16 q and cache [4608, 8, 576], lengths across
    # the 16-key steps, the 64-row stages and the splits
    cache = _latent_cache(gen, T, b, L, 4161)
    q = _randn(gen, b, n, L)
    for length in (1, 15, 16, 17, 511, 512, 513, 4097, 4161):
        held(q, cache, length, path=tc)
    # off the path: an fp32 cache and queries (the JAX package's fp32
    # end-to-end tests), a 1280-row buffer (256-row tiles in JAX), short
    # buffers, 128 heads (8 head groups), each row at its own length, and
    # dead rows holding 1e4 that must stay invisible
    held(q.float(), cache.float(), 2049, path=first)
    held(q, cache.float(), 700, path=first)
    held(q.float(), cache, 700, path=first)
    for T_off, length in ((1280, 1280), (1280, 1001), (512, 512), (40, 7)):
        held(q, _latent_cache(gen, T_off, b, L, length), length, path=tc)
    held(_randn(gen, 2, 128, L), _latent_cache(gen, 600, 2, L, 600), 333,
         path=tc)
    rows = torch.tensor([1, 31, 32, 33, 160, 161, 2000, 4608],
                        dtype=torch.int32, device="cuda")
    held(q, _latent_cache(gen, T, b, L, T), rows, path=tc)
    poisoned = cache.clone()
    poisoned[1000:] = 1e4
    got, _ = held(q, poisoned, 1000, path=tc)
    clean, _ = held(q, cache, 1000, path=tc)
    torch.testing.assert_close(got, clean, rtol=0, atol=0)
    held(q[:, :, :64].contiguous(), cache[..., :64].contiguous(), 99, lat=32,
         path=first)  # another lat
    held(q[..., :256].contiguous(), cache[..., :256].contiguous(), 99,
         lat=128, path=first)
    held(_randn(gen, b, n, 584), _latent_cache(gen, 600, b, 584, 600), 333,
         path=first)  # L not a multiple of 64
    held(_randn(gen, 2, n, 1024), _latent_cache(gen, 300, 2, 1024, 300), 257,
         path=first)  # the stages overflow shared memory
    # the tensor-core body twice: bit-identical (the merge tree's order
    # does not follow the blocks' arrival)
    again = [mla_decode.mla_flash_decode(q, cache, 4129, lat, scale)
             for _ in range(2)]
    assert torch.equal(again[0], again[1])

    # deepseek_v2_lite's steps: a [1024, 8, 576] bf16 cache, lengths from
    # the prompt's end to the last step's
    T2, P2 = V2_LITE_CFG["max_decode_length"], V2_PROMPT
    cache2 = _latent_cache(gen, T2, V2_BATCH, L, P2 + V2_NEW - 1)
    q2 = _randn(gen, V2_BATCH, V2_LITE_CFG["num_heads"], L)
    for length in (P2 + 1, P2 + V2_NEW // 2, P2 + V2_NEW - 1):
        held(q2, cache2, length, path=tc)
    log(f"kernel mla_decode: mla_plan's branches held to the plain version "
        f"within {MLA_TOL} (tensor cores {taken[tc]} cases, first design "
        f"{taken[first]}); the tensor-core body run twice bit-identical")

    # the entries: a mid-run decode step of each path, with the first
    # design and the planted faults at the same shape
    held(q, cache, MLA_DECODE_LENGTH, path=tc)
    v2_length = P2 + V2_NEW // 2
    design = {"mla_decode": _mla_design_and_faults(
        "mla_decode", q, cache, MLA_DECODE_LENGTH, lat, scale),
              "deepseek_v2_lite": _mla_design_and_faults(
        "deepseek_v2_lite", q2, cache2, v2_length, lat, scale)}
    _mla_split_sweep("mla_decode", q, cache, MLA_DECODE_LENGTH, lat, scale)
    _mla_split_sweep("deepseek_v2_lite", q2, cache2, v2_length, lat, scale)
    entries = [_mla_entry("mla_decode", q, cache, MLA_DECODE_LENGTH, lat,
                          scale),
               _mla_entry("deepseek_v2_lite", q2, cache2, v2_length, lat,
                          scale)]
    for e, label in zip(entries, ("mla_decode", "deepseek_v2_lite")):
        e["first_design_ms"] = design[label]
    return entries


def _mla_entry(label, q, cache, length, lat, scale):
    """The MLA decode kernel, its plain version and SDPA timed at one
    step of a path (held by check_mla_decode's ``held`` before)."""
    from apex_tpu_torch.contrib import mla_decode
    b, n, L = q.shape
    got = mla_decode.mla_flash_decode(q, cache, length, lat, scale)
    want = mla_decode.mla_decode_reference(q, cache, length, lat, scale)
    k_l = cache[:length].permute(1, 0, 2)[:, None]  # [b, 1, len, L]
    e = entry(
        "mla_decode", f"{label}: q[{b},{n},{L}] bf16, cache"
        f"[{cache.shape[0]},{b},{L}] bf16, length {length}", got, want,
        f"rtol {MLA_TOL} atol {MLA_TOL}",
        lambda: mla_decode.mla_flash_decode(q, cache, length, lat, scale),
        lambda: mla_decode.mla_decode_reference(q, cache, length, lat, scale),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q.reshape(b, n, 1, L), k_l, k_l[..., :lat], scale=scale,
            enable_gqa=True),
        _mla_bound(b, n, L, lat, [length] * b))
    e["earlier_bound_ms"] = _mla_bound_fp32(b, n, L, lat, [length] * b)[0]
    return e


def check_refusals():
    """On a CUDA tensor a wrapper launches its kernel or raises: what the
    kernels do not take is refused, never sent to the plain version."""
    from apex_tpu_torch.contrib import fmha, gqa_decode
    from apex_tpu_torch.kernels import fused_cc, norm, optim, registry, softmax

    def refused(exc, fn):
        try:
            fn()
        except exc:
            return
        raise AssertionError(f"{fn} was not refused with {exc.__name__}")

    before = registry.launches()
    q = torch.zeros(3, 2, 2, 4, 64, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(16, 2, 2, 64, dtype=torch.bfloat16, device="cuda")
    strided = torch.zeros(3, 2, 2, 8, 64, dtype=torch.bfloat16,
                          device="cuda")[:, :, :, ::2]
    refused(TypeError, lambda: norm.rms_fwd(q[0, 0, 0].half(), None, 1e-5))
    refused(ValueError, lambda: norm.rms_fwd(q[0, 0, 0].t(), None, 1e-5))
    refused(ValueError, lambda: fused_cc.window_attention(
        strided, k, k, 0, 0.1))
    refused(ValueError, lambda: fused_cc.window_attention(q, k, k, 14, 0.1))
    refused(ValueError, lambda: gqa_decode.gqa_flash_decode(
        q[0], k, k, 17, 0.1))
    refused(ValueError, lambda: gqa_decode.gqa_flash_decode(  # head dim 32
        q[0, ..., :32].contiguous(), k[..., :32].contiguous(),
        k[..., :32].contiguous(), 4, 0.1))
    # contiguous, but off a 16-byte boundary (the kernels copy 16 bytes)
    shifted = torch.zeros(q.numel() + 1, dtype=q.dtype,
                          device="cuda")[1:].view(q.shape)
    refused(ValueError, lambda: fused_cc.window_attention(
        shifted, k, k, 0, 0.1))
    refused(ValueError, lambda: gqa_decode.gqa_flash_decode(
        shifted[0], k, k, 1, 0.1))
    # the training kernels
    x = torch.zeros(4, 64, device="cuda")
    refused(TypeError, lambda: norm.rms_bwd_dx(x.half(), x, None, 1e-5))
    refused(ValueError, lambda: norm.rms_bwd_dx(x, x[:, :32], None, 1e-5))
    refused(ValueError, lambda: norm.rms_bwd_dx(x.t(), x.t(), None, 1e-5))
    refused(ValueError, lambda: norm.rms_bwd_dx(
        x, x, torch.ones(32, device="cuda"), 1e-5))
    s3 = torch.zeros(2, 8, 8, device="cuda")
    refused(ValueError, lambda: softmax.causal_softmax_fwd(s3[None], 1.0))
    refused(ValueError, lambda: softmax.causal_softmax_fwd(
        s3.transpose(1, 2), 1.0))
    refused(TypeError, lambda: softmax.causal_softmax_fwd(s3.half(), 1.0))
    refused(ValueError, lambda: softmax.causal_softmax_fwd(torch.zeros(
        1, 1, softmax.MAX_KEYS + 1, device="cuda"), 1.0))
    refused(TypeError, lambda: softmax.softmax_bwd(s3, s3.bfloat16(), 1.0))
    refused(ValueError, lambda: softmax.softmax_bwd(s3, s3[:, :4], 1.0))
    t = [torch.zeros(8, device="cuda")]
    kw = dict(lr=1e-3, bc1=0.1, bc2=0.001, b1=0.9, b2=0.999, eps=1e-8,
              weight_decay=0.0, adam_w=True)
    noop = torch.zeros(1, device="cuda")
    refused(TypeError, lambda: optim.adam(noop, t, t, [t[0].bfloat16()], t,
                                          **kw))  # a bf16 exp_avg
    refused(ValueError, lambda: optim.adam(
        noop, t, t, t, [torch.zeros(4, device="cuda")], **kw))
    refused(ValueError, lambda: optim.adam(noop, t * 2, t, t, t, **kw))
    refused(ValueError, lambda: optim.adam(torch.zeros(2, device="cuda"),
                                           t, t, t, t, **kw))
    uneven = [torch.zeros(16, device="cuda")[::2]]
    refused(ValueError, lambda: optim.adam(noop, uneven, uneven, uneven,
                                           uneven, **kw))
    # the flash kernels
    fq = torch.zeros(1, 2, 128, 64, device="cuda")
    lse = torch.zeros(1, 2, 128, device="cuda")
    refused(ValueError, lambda: fmha.flash_fwd(  # head dim 32
        *[fq[..., :32].contiguous()] * 3, 0.1, True))
    refused(ValueError, lambda: fmha.flash_fwd(fq, fq, fq.transpose(2, 3)
                                               .contiguous().transpose(2, 3),
                                               0.1, True))
    refused(ValueError, lambda: fmha.flash_fwd(fq[0], fq[0], fq[0], 0.1,
                                               True))
    refused(ValueError, lambda: fmha.flash_fwd(fq, fq[:, :, :64], fq, 0.1,
                                               True))
    refused(TypeError, lambda: fmha.flash_fwd(*[fq.half()] * 3, 0.1, True))
    refused(TypeError, lambda: fmha.flash_fwd(fq, fq.bfloat16(), fq, 0.1,
                                              True))
    refused(ValueError, lambda: fmha.flash_fwd(fq, fq, fq, 0.1, True, 0))
    refused(ValueError, lambda: fmha.flash_fwd(
        fq, fq, fq, 0.1, True, alibi_slopes=torch.zeros(3, device="cuda")))
    refused(ValueError, lambda: fmha.flash_dq(fq, fq, fq, fq, lse[..., :64],
                                              lse, 0.1, True))
    refused(ValueError, lambda: fmha.flash_dkv(fq, fq, fq, fq, lse,
                                               lse.double(), 0.1, True))
    refused(TypeError, lambda: fmha.flash_dkv(fq, fq, fq, fq.bfloat16(), lse,
                                              lse, 0.1, True))
    refused(ValueError, lambda: fmha.flash_bwd(fq, fq, fq, fq.bfloat16(), lse,
                                               fq, 0.1, True))
    # the LayerNorm, scaled/masked softmax and LAMB kernels
    w64 = torch.ones(64, device="cuda")
    refused(TypeError, lambda: norm.ln_fwd(x.half(), w64, w64, 1e-5))
    refused(ValueError, lambda: norm.ln_fwd(x.t(), None, None, 1e-5))
    refused(ValueError, lambda: norm.ln_fwd(x, w64[:32], None, 1e-5))
    refused(ValueError, lambda: norm.ln_fwd(x, w64, w64.double(), 1e-5))
    refused(ValueError, lambda: norm.ln_fwd(x[None], None, None, 1e-5))
    refused(ValueError, lambda: norm.ln_bwd_dx(x, x[:, :32], w64, 1e-5))
    refused(TypeError, lambda: norm.ln_bwd_dx(x.half(), x, w64, 1e-5))
    refused(ValueError, lambda: norm.ln_bwd_dx(x.t(), x.t(), None, 1e-5))
    s4 = torch.zeros(2, 2, 8, 8, device="cuda")
    m4 = torch.zeros(2, 1, 8, 8, dtype=torch.bool, device="cuda")
    refused(ValueError, lambda: softmax.scaled_masked_softmax_fwd(
        s4, m4[:, :, :4], 1.0))  # does not broadcast
    refused(ValueError, lambda: softmax.scaled_masked_softmax_fwd(
        s4[None], m4, 1.0))  # 5 dims
    refused(ValueError, lambda: softmax.scaled_masked_softmax_fwd(
        s4.transpose(2, 3), m4, 1.0))
    refused(TypeError, lambda: softmax.scaled_masked_softmax_fwd(
        s4.half(), m4, 1.0))
    refused(ValueError, lambda: softmax.scaled_masked_softmax_fwd(
        s4, m4.cpu(), 1.0))  # two devices
    refused(ValueError, lambda: softmax.scaled_softmax_fwd(torch.zeros(
        1, softmax.MAX_KEYS + 1, device="cuda"), 1.0))
    refused(ValueError, lambda: softmax.scaled_softmax_fwd(
        s4[..., :0], 1.0))
    lkw = dict(clip=None, bc1=0.1, bc2=0.001, b1=0.9, b2=0.999, beta3=0.1,
               eps=1e-6, weight_decay=0.01, adam_w=True)
    refused(TypeError, lambda: optim.lamb(noop, [t[0].bfloat16()], t, t, t,
                                          **lkw))
    refused(ValueError, lambda: optim.lamb(noop, t * 2, t, t, t, **lkw))
    refused(ValueError, lambda: optim.lamb(
        noop, t, t, t, t, **dict(lkw, clip=torch.ones(2, device="cuda"))))
    refused(ValueError, lambda: optim.lamb(noop, uneven, uneven, uneven,
                                           uneven, **lkw))
    # the int8 serving kernels, and per-row offsets
    from apex_tpu_torch.kernels import quant
    xq = torch.zeros(4, 256, device="cuda")
    refused(TypeError, lambda: quant.quantize_rows(xq.half(), 256))
    refused(ValueError, lambda: quant.quantize_rows(xq.t(), 256))
    refused(ValueError, lambda: quant.quantize_rows(xq[None], 256))
    refused(ValueError, lambda: quant.quantize_rows(xq, 0))
    q8 = torch.zeros(4, 1, 256, dtype=torch.int8, device="cuda")
    s8 = torch.ones(4, 1, 1, device="cuda")
    refused(TypeError, lambda: quant.dequantize_rows(q8.short(), s8))
    refused(ValueError, lambda: quant.quantize_rows(xq, 256, s8[:2]))
    refused(ValueError, lambda: quant.quantize_rows(xq, 256, s8.double()))
    # the int4 kernels
    from apex_tpu_torch.kernels import quant4
    x4 = torch.zeros(4, 256, device="cuda")
    s4 = torch.ones(4, 1, device="cuda")
    c4 = torch.zeros(4, 256, dtype=torch.int8, device="cuda")
    p4 = torch.zeros(4, 128, dtype=torch.uint8, device="cuda")
    refused(TypeError, lambda: quant4.quantize_int4(x4.bfloat16(), s4))
    refused(ValueError, lambda: quant4.quantize_int4(x4[:, ::2], s4))
    refused(ValueError, lambda: quant4.quantize_int4(x4, s4[:3]))
    refused(ValueError, lambda: quant4.quantize_int4(x4, s4.double()))
    refused(ValueError, lambda: quant4.quantize_int4(x4[None], s4))
    refused(ValueError, lambda: quant4.dequantize_int4(c4, s4[:2]))
    refused(ValueError, lambda: quant4.dequantize_int4(c4[:, ::2], s4))
    refused(TypeError, lambda: quant4.dequantize_int4(c4.int(), s4))
    refused(TypeError, lambda: quant4.dequantize_int4(c4.float(), s4))
    refused(TypeError, lambda: quant4.quantize_pack_int4(x4.bfloat16(), s4))
    refused(ValueError, lambda: quant4.quantize_pack_int4(x4[:, ::2], s4))
    refused(ValueError, lambda: quant4.quantize_pack_int4(x4, s4[:3]))
    refused(TypeError, lambda: quant4.unpack_dequantize_int4(c4, s4))
    refused(ValueError, lambda: quant4.unpack_dequantize_int4(p4[:, ::2],
                                                              s4))
    refused(ValueError, lambda: quant4.unpack_dequantize_int4(p4, s4[:2]))
    refused(ValueError, lambda: quant4.unpack_dequantize_int4(p4, s4, 257))
    refused(TypeError, lambda: quant4.pack_int4(p4))
    refused(ValueError, lambda: quant4.pack_int4(c4[:, ::2]))
    refused(TypeError, lambda: quant4.unpack_int4(c4))
    refused(ValueError, lambda: quant4.unpack_int4(p4[:, ::2]))
    refused(ValueError, lambda: quant4.unpack_int4(p4, 257))
    refused(ValueError, lambda: quant4.quantize_int4(x4, s4.cpu()))
    refused(ValueError, lambda: quant.dequantize_rows(q8, s8[:2]))
    refused(ValueError, lambda: quant.dequantize_rows(q8, s8, 300))
    refused(ValueError, lambda: quant.dequantize_rows(q8, s8.double()))
    refused(TypeError, lambda: quant.dequantize_rows(
        q8, s8, out_dtype=torch.half))
    kq = torch.zeros(16, 2, 1, 256, dtype=torch.int8, device="cuda")
    ks = torch.ones(16, 2, 1, 1, device="cuda")
    qv = torch.zeros(3, 2, 4, 2, 64, dtype=torch.bfloat16, device="cuda")
    refused(ValueError, lambda: fused_cc.spec_verify_attention(
        qv, kq, ks, kq, ks, 14, 0.1))  # positions past the cache
    refused(ValueError, lambda: fused_cc.spec_verify_attention(  # g*d 320
        torch.zeros(3, 2, 5, 2, 64, dtype=torch.bfloat16, device="cuda"),
        kq, ks, kq, ks, 0, 0.1))
    refused(TypeError, lambda: fused_cc.spec_verify_attention(
        qv, kq.float(), ks, kq, ks, 0, 0.1))
    refused(TypeError, lambda: fused_cc.spec_verify_attention(
        qv, kq, ks.bfloat16(), kq, ks, 0, 0.1))
    refused(ValueError, lambda: fused_cc.spec_verify_attention(
        qv, kq, ks[:8], kq, ks, 0, 0.1))
    refused(ValueError, lambda: fused_cc.spec_verify_attention(
        qv, kq[:, :1], ks, kq, ks, 0, 0.1))
    refused(TypeError, lambda: fused_cc.spec_verify_attention(
        qv.half(), kq, ks, kq, ks, 0, 0.1))
    refused(ValueError, lambda: fused_cc.spec_verify_attention(
        qv, kq, ks, kq, ks, torch.zeros(3, dtype=torch.int32,
                                        device="cuda"), 0.1))
    refused(TypeError, lambda: fused_cc.window_attention(
        q, k, k, torch.zeros(2, device="cuda"), 0.1))
    refused(ValueError, lambda: gqa_decode.gqa_flash_decode(
        q[0], k, k, torch.ones(3, dtype=torch.int32, device="cuda"), 0.1))
    # the MLA decode kernel
    from apex_tpu_torch.contrib import mla_decode
    mq = torch.zeros(2, 4, 576, dtype=torch.bfloat16, device="cuda")
    mc = torch.zeros(64, 2, 576, dtype=torch.bfloat16, device="cuda")
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc, 0, 512, 0.1))  # no live row
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc, torch.tensor([0, 4], dtype=torch.int32, device="cuda"), 512,
        0.1))  # no live row in one batch row
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc[:, :1], 4, 512, 0.1))  # batch rows differ
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc, 4, 576 + 4, 0.1))  # lat past the row
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc, 4, 510, 0.1))  # lat not a multiple of 4
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq[..., :572].contiguous(), mc[..., :572].contiguous(), 4, 512,
        0.1))  # L not a multiple of 8
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq[0], mc, 4, 512, 0.1))  # q not [b, n, L]
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc.transpose(0, 1).contiguous().transpose(0, 1), 4, 512, 0.1))
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        torch.zeros(2 * 4 * 576 + 4, dtype=torch.bfloat16, device="cuda")[
            4:].view(2, 4, 576), mc, 4, 512, 0.1))  # off a 16-byte boundary
    refused(TypeError, lambda: mla_decode.mla_flash_decode(
        mq.half(), mc, 4, 512, 0.1))
    refused(TypeError, lambda: mla_decode.mla_flash_decode(
        mq, mc.half(), 4, 512, 0.1))
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc, torch.ones(3, dtype=torch.int32, device="cuda"), 512, 0.1))
    refused(TypeError, lambda: mla_decode.mla_flash_decode(
        mq, mc, torch.ones(2, device="cuda"), 512, 0.1))
    refused(ValueError, lambda: mla_decode.mla_flash_decode(
        mq, mc.cpu(), 4, 512, 0.1))  # two devices
    # the TP GEMM
    tx = torch.zeros(16, 64, device="cuda")
    tw = torch.zeros(64, 32, device="cuda")
    refused(TypeError, lambda: fused_cc._matmul(tx.half(), tw))
    refused(TypeError, lambda: fused_cc._matmul(tx, tw.double()))
    refused(ValueError, lambda: fused_cc._matmul(tx, tw[:32]))  # k differs
    refused(ValueError, lambda: fused_cc._matmul(tx, tw[None]))  # 3-D w
    refused(ValueError, lambda: fused_cc._matmul(tx[:0], tw))  # no rows
    refused(ValueError, lambda: fused_cc._matmul(  # w's columns apart
        tx, torch.zeros(64, 64, device="cuda")[:, ::2]))
    refused(ValueError, lambda: fused_cc._matmul(  # x's columns apart
        torch.zeros(16, 128, device="cuda")[:, ::2], tw))
    refused(ValueError, lambda: fused_cc._matmul(tx, tw.cpu()))
    # amp's kernels
    from apex_tpu_torch.kernels import scale as ks
    flag, one = torch.zeros(1, device="cuda"), torch.ones(1, device="cuda")
    step = torch.ones(1, dtype=torch.int32, device="cuda")
    g = [torch.zeros(5, device="cuda")]
    refused(TypeError, lambda: ks.scale(flag, [g[0].half()], g, one))
    refused(ValueError, lambda: ks.scale(flag, g, [g[0][:3]], one))
    refused(ValueError, lambda: ks.scale(flag.double(), g, g, one))
    refused(ValueError, lambda: ks.axpby(flag, g, g * 2, g, 1.0, 1.0))
    adam_kw = dict(step=step, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay=0.0, adam_w=True)
    refused(TypeError, lambda: optim.adam(  # a bf16 master
        flag, g, [g[0].bfloat16()], g, g, [g[0].bfloat16()], **adam_kw))
    refused(ValueError, lambda: optim.adam(  # an fp32 step
        flag, g, g, g, g, **dict(adam_kw, step=step.float())))
    refused(ValueError, lambda: optim.adam(  # neither corrections nor step
        flag, g, g, g, g, **dict(adam_kw, step=None)))
    refused(TypeError, lambda: optim.sgd(  # bf16 params
        flag, g, [g[0].bfloat16()], g, step=step, lr=0.1))
    refused(ValueError, lambda: optim.lamb(  # a flag of two elements
        flag, g, g, g, g, g, found_inf=torch.zeros(2, device="cuda"),
        clip=None, step=step, b1=0.9, b2=0.999, beta3=0.1, eps=1e-6,
        weight_decay=0.0, adam_w=True))
    refused(TypeError, lambda: optim.lamb(  # the update over a bf16 grad
        flag, [g[0].bfloat16()], g, g, g, clip=None, step=step, b1=0.9,
        b2=0.999, beta3=0.1, eps=1e-6, weight_decay=0.0, adam_w=True))
    refused(ValueError, lambda: optim.lamb_stage2(  # factors of 2 tensors
        flag, None, g, g, None, torch.zeros(2, device="cuda")))
    assert registry.launches() == before, "a refused call was counted"
    log("kernels: malformed CUDA inputs are refused (dtype, layout, range, "
        "head dim, shapes, list lengths, window, slopes, lse/delta, "
        "weight/bias, masks that do not broadcast, clip, block, scales, "
        "codes, lanes, per-row offsets, latent widths, alignment, GEMM "
        "operands, amp's flags, steps, masters and factors)")


# ------------------------------------------------------------- phases 3, 4

def profile_window(label, fn, top=6, watch=(), ranges=()):
    """Device busy share of one call of ``fn`` under torch.profiler (the
    kernels' summed time over the span from the first kernel's start to
    the last one's end), the kernels that take most of it, and the summed
    time of the kernels whose names contain each string of ``watch``.
    For each name in ``ranges`` (a ``record_function`` range), the
    device-side span of that range and the kernel time inside it. Returns
    {"busy_us", "span_us", "watch": {part: us}, "ranges": {name: (span_us,
    busy_us)}} (None when the profiler saw no device work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]  # ranges, not device work
    if not kernels:
        log(f"profile {label}: the profiler saw no device work; busy share "
            f"not measured")
        return None
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    log(f"profile {label}: {len(kernels)} device ops, busy {busy:.1f} us of "
        f"a {span:.1f} us span ({busy / span:.3f}; under the profiler)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        n = sum(1 for e in kernels if e.name == name)
        log(f"  {us:9.1f} us {n:5d}x {name[:90]}")
    stats = dict(busy_us=busy, span_us=span, watch={}, ranges={})
    for part in watch:
        names = [k for k in by_name if part in k]
        us = sum(by_name[k] for k in names)
        n = sum(1 for e in kernels if part in e.name)
        stats["watch"][part] = us
        log(f"  kernels named *{part}*: {us:.1f} us in {n} launches "
            f"({us / busy:.4f} of the busy time)")
    for name in ranges:  # record_function ranges: their kernels' time
        found = [e for e in prof.events()
                 if e.device_type == DeviceType.CPU and e.name == name]
        if not found:
            log(f"  range {name}: not in the profile; not measured")
            continue
        us = sum(_device_us(e) for e in found)
        host_us = sum(e.time_range.elapsed_us() for e in found)
        stats["ranges"][name] = us
        log(f"  range {name}: its kernels {us:.1f} us on the device "
            f"({us / busy:.4f} of the busy time); {host_us:.1f} us on the "
            f"host")
    return stats


def _device_us(event):
    """The device time of the kernels launched inside a profiler range
    (the attribute's name differs between torch releases)."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    raise AttributeError("the profiler's events carry no device time")


def _wall_ms(fn):
    """(host ms of one synchronized call of ``fn``, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _spread(xs):
    xs = sorted(xs)
    return (f"median {statistics.median(xs):.2f} ms, min {xs[0]:.2f}, "
            f"max {xs[-1]:.2f} over {len(xs)}")


def phase_serving():
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import (
        GPTModel,
        TransformerConfig,
        decode_step,
        generate,
        init_cache,
        init_weights,
        prefill,
    )
    cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = GPTModel(cfg)  # on the card by default
    init_weights(model, SEED)
    torch.cuda.synchronize()
    log(f"slice: GPTModel {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {sum(p.numel() for p in model.parameters())} "
        f"params on {model.device} in {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(SEED))

    # the main path, counted
    registry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the serving path's own peak
    t0 = time.perf_counter()
    tokens = generate(model, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = registry.launches()
    forwards = NEW_TOKENS  # one prefill + NEW_TOKENS - 1 decode steps
    expected = {**dict.fromkeys(launches, 0),  # no training kernel
                "rms_norm": (2 * cfg.num_layers + 1) * forwards,
                "window_attention": cfg.num_layers,
                "gqa_decode": cfg.num_layers * (forwards - 1)}
    log(f"slice: generate({BATCH}x{PROMPT} prompt, {NEW_TOKENS} new tokens,"
        f" greedy) in {gen_s * 1e3:.1f} ms; launches {launches}, expected "
        f"{expected}")
    assert launches == expected, (launches, expected)
    assert tokens.shape == (BATCH, PROMPT + NEW_TOKENS), tokens.shape
    assert torch.equal(tokens[:, :PROMPT].cpu(), prompt)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size

    # the same model through the plain versions: prefill and first step
    def first_two(plain):
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            cache = init_cache(model, BATCH)
            pos = torch.arange(PROMPT, device=model.device)[None, :]
            cache, logits0 = prefill(model, cache, prompt.cuda(), pos)
            nxt = tokens[:, PROMPT:PROMPT + 1]
            _, logits1 = decode_step(
                model, cache, nxt,
                torch.full((BATCH, 1), PROMPT, device=model.device))
        return logits0, logits1

    k0, k1 = first_two(plain=False)
    registry.reset()
    p0, p1 = first_two(plain=True)
    with plain_versions():
        plain_tokens = generate(model, prompt, NEW_TOKENS)
    assert not any(registry.launches().values()), registry.launches()
    _hold_logits("slice: prefill", k0, p0)
    _hold_logits("slice: step 1", k1, p1)
    first = tokens[:, PROMPT]
    assert torch.equal(first, torch.argmax(p0, dim=-1)), "first token"
    agree = (tokens[:, PROMPT:] == plain_tokens[:, PROMPT:]).float().mean()
    log(f"slice: first token identical in all {BATCH} rows; generated "
        f"tokens equal to the plain path's: {agree.item():.4f}")

    # prefill ms and decode tokens/s through the entry points
    def run_prefill():
        cache = init_cache(model, BATCH)
        pos = torch.arange(PROMPT, device=model.device)[None, :]
        return prefill(model, cache, prompt.cuda(), pos)

    run_prefill()  # warm
    prefill_ms = [_wall_ms(run_prefill)[0] for _ in range(7)]
    cache, logits = run_prefill()
    nxt = tokens[:, PROMPT:PROMPT + 1]

    def step(i):
        return decode_step(
            model, cache, nxt,
            torch.full((BATCH, 1), PROMPT + i, device=model.device))

    step_ms = []
    for i in range(NEW_TOKENS - 1):
        ms, (cache, logits) = _wall_ms(lambda: step(i))
        step_ms.append(ms)
    med = statistics.median(step_ms)
    log(f"slice: prefill ({BATCH}x{PROMPT} tokens) {_spread(prefill_ms)}; "
        f"decode step {_spread(step_ms)} = {BATCH / med * 1e3:.1f} tokens/s "
        f"at batch {BATCH} (host clock, synchronized); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_window("prefill", run_prefill)
    cache, _ = run_prefill()
    profile_window("decode step", lambda: step(0))
    return {"serving": launches, "beam_search": _beam_path(model, prompt,
                                                          tokens),
            "prefix_generate": _prefix_generate_path(model)}


def _rows_check(label, model, prompts, got, want):
    """Row i of ``got`` against row i of ``want`` (generated tokens), each
    row's context ``prompts[i]``: where a row differs, both tokens at the
    first difference must lie within LOGIT_TOL of the top logit of the
    context (the prompt and ``want``'s tokens before it) prefilled
    through the kernels: a tie among the leading tokens that a
    last-place difference may break either way, not a wrong token. The
    serve phases' top-2 rule (:func:`_margin_check`) reads a three-way
    tie as a failure: one within 0.0062 occurred on this path on an H100
    80GB HBM3."""
    from apex_tpu_torch.models import init_cache, prefill
    same = 0
    for i, (a, b) in enumerate(zip(got.tolist(), want.tolist())):
        if a == b:
            same += 1
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = torch.cat([prompts[i].cpu(), torch.as_tensor(b[:j])]).to(
            model.device)[None]
        _, logits = prefill(model, init_cache(model, 1), ctx, torch.arange(
            ctx.shape[1], device=model.device)[None])
        logits = logits[0].float()
        top = logits.max().item()
        gaps = [top - logits[t].item() for t in (a[j], b[j])]
        log(f"{label}: row {i} first differs at generated token {j} "
            f"({a[j]} vs {b[j]}); their logits {gaps[0]:.4f} and "
            f"{gaps[1]:.4f} below the top (tolerance {LOGIT_TOL})")
        assert max(gaps) < LOGIT_TOL, (label, i, j, gaps)
    log(f"{label}: {same} of {len(got)} rows identical")


def _beam_path(model, prompt, greedy):
    """beam_search over the serving phase's 8 x 128 prompt, BEAMS beams a
    row, NEW_TOKENS tokens, counted; one beam against greedy generate
    (``greedy``); the kernels held against their plain versions on the
    beam path's prefill and first beam step."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import (
        beam_search,
        decode_step,
        init_cache,
        prefill,
    )
    L = model.num_layers
    beam_search(model, prompt, 2, BEAMS)  # warm
    registry.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = beam_search(model, prompt, NEW_TOKENS, BEAMS)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    launches = registry.launches()
    _expect("beam_search", launches, {
        "rms_norm": (2 * L + 1) * NEW_TOKENS, "window_attention": L,
        "gqa_decode": L * (NEW_TOKENS - 1)})
    assert seqs.shape == (BATCH, PROMPT + NEW_TOKENS), seqs.shape
    assert torch.equal(seqs[:, :PROMPT].cpu(), prompt)
    assert torch.isfinite(scores).all() and (scores <= 0).all(), scores
    log(f"beam_search: {BATCH} x {PROMPT} prompt, {BEAMS} beams, "
        f"{NEW_TOKENS} new tokens in {beam_s * 1e3:.1f} ms ("
        f"{BATCH * NEW_TOKENS / beam_s:.1f} best-beam tokens/s); scores "
        f"{[round(x, 4) for x in scores.tolist()]}")
    one, _ = beam_search(model, prompt, NEW_TOKENS, 1)
    _rows_check("beam_search with one beam vs greedy generate", model,
                prompt, one[:, PROMPT:], greedy[:, PROMPT:])

    def first_step(plain):
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            cache = init_cache(model, BATCH)
            pos = torch.arange(PROMPT, device=model.device)[None, :]
            cache, logits0 = prefill(model, cache, prompt.cuda(), pos)
            cache = cache.repeat_rows(BEAMS)
            nxt = seqs[:, PROMPT].repeat_interleave(BEAMS)[:, None]
            _, logits1 = decode_step(
                model, cache, nxt,
                torch.full((BATCH * BEAMS, 1), PROMPT, device=model.device))
        return logits0, logits1

    k0, k1 = first_step(plain=False)
    p0, p1 = first_step(plain=True)
    _hold_logits("beam_search: prefill", k0, p0)
    _hold_logits("beam_search: first beam step (32 rows)", k1, p1)
    with plain_versions():
        pseqs, pscores = beam_search(model, prompt, NEW_TOKENS, BEAMS)
    same = (pseqs == seqs).all(dim=1).sum().item()
    log(f"beam_search: {same} of {BATCH} best beams identical to the plain "
        f"versions' (not a check: a near tie may pick another beam); "
        f"largest score difference "
        f"{(pscores - scores).abs().max().item():.3e}")
    return launches


def _prefix_generate_path(model):
    """prefill_prefix of a SHARED_PREFIX-token batch-1 prefix, then
    generate(prefix_state=) of 8 SUFFIX-token suffixes, counted, against
    generate over the concatenated prompts; both prefills timed."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import (
        generate,
        init_cache,
        prefill,
        prefill_prefix,
    )
    L, vocab = model.num_layers, model.config.vocab_size
    gen = torch.Generator().manual_seed(SEED + 1)
    shared = torch.randint(0, vocab, (1, SHARED_PREFIX), generator=gen)
    suffix = torch.randint(0, vocab, (BATCH, SUFFIX), generator=gen)
    full = torch.cat([shared.expand(BATCH, -1), suffix], dim=1).cuda()
    generate(model, suffix, 2, prefix_state=prefill_prefix(model, shared))
    registry.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = prefill_prefix(model, shared)
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t0
    out = generate(model, suffix, NEW_TOKENS, prefix_state=state)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0 - prefix_s
    launches = registry.launches()
    _expect("prefix_generate", launches, {
        "rms_norm": (2 * L + 1) * (NEW_TOKENS + 1),
        "window_attention": 2 * L, "gqa_decode": L * (NEW_TOKENS - 1)})
    assert out.shape == (BATCH, SUFFIX + NEW_TOKENS), out.shape
    want = generate(model, full, NEW_TOKENS)
    _rows_check("prefix_generate vs generate over the full prompt", model,
                full, out[:, SUFFIX:], want[:, SHARED_PREFIX + SUFFIX:])
    pos = SHARED_PREFIX + torch.arange(SUFFIX, device=model.device)[None, :]
    _, seeded_logits = prefill(model, state[0].broadcast_rows(BATCH),
                               suffix.cuda(), pos, full_logits=True)
    _, full_logits = prefill(model, init_cache(model, BATCH), full,
                             torch.arange(full.shape[1],
                                          device=model.device)[None, :],
                             full_logits=True)
    _hold_logits("prefix_generate: the suffix prefill over the prefix vs "
                 "the full prompt's prefill, at the suffix positions,",
                 seeded_logits, full_logits[:, SHARED_PREFIX:])
    seeded = [_wall_ms(lambda: prefill(
        model, state[0].broadcast_rows(BATCH), suffix.cuda(), pos))[0]
        for _ in range(7)]
    cold = [_wall_ms(lambda: prefill(
        model, init_cache(model, BATCH), full, torch.arange(
            full.shape[1], device=model.device)[None, :]))[0]
        for _ in range(7)]
    log(f"prefix_generate: prefill_prefix ({SHARED_PREFIX} tokens, batch 1) "
        f"{prefix_s * 1e3:.1f} ms once; generate of {BATCH} x {SUFFIX} "
        f"suffixes + {NEW_TOKENS} new tokens {gen_s * 1e3:.1f} ms; the "
        f"suffix prefill over the prefix (the broadcast copy included) "
        f"{_spread(seeded)} against a prefill of the full {BATCH} x "
        f"{full.shape[1]} prompts {_spread(cold)}")
    return launches


def _rel_fro(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def train_steps(label, model, loss_of, make_opt, per_step, work,
                update_rtol=(TRAIN_UPDATE_RTOL, TRAIN_TENSOR_UPDATE_RTOL),
                falls_from=0, linear_below=None, sync=None, hold_plain=True,
                record=None, watch=None, ranges=(), backward=None, held=None,
                step_guard=contextlib.nullcontext, same_sign_tensors=False):
    """Three counted steps of ``loss_of()`` (the forward and loss),
    backward, ``opt.step()`` and ``zero_grad`` with every launch count
    set to 0 before each step and checked against ``per_step`` after it
    (kernels not named there: 0), then the timed steps, a profile, and
    step 1 again from the same weights through the plain versions.
    ``work`` is (count, unit) of one step, e.g. (16384, "tokens").
    ``update_rtol``: the step-1 update errors allowed over all
    parameters and for each tensor. The last counted step's loss must be
    below that of step ``falls_from + 1``. ``linear_below(g1)``, given
    the step-1 gradients, gives the |g| under which the optimizer's first
    update is linear in g (not sign-like): the share of sign flips there
    is printed. ``sync(k)``, if given, runs between backward and the
    optimizer's step (k: the counted step, or None for a later one).
    ``hold_plain=False`` leaves out the step-1 hold against the plain
    versions. ``record``, a dict, receives the counted steps' losses
    ("losses") and the profile's stats ("profile"). ``backward(loss,
    opt)`` replaces ``loss.backward()`` (amp: the scaled loss's);
    ``held(opt)`` gives {name: tensor} whose step-1 change is held (amp
    O2: the fp32 masters; the parameters by default); every
    ``opt.step()`` runs inside ``step_guard()``. ``same_sign_tensors``:
    each tensor's step-1 update is held over the entries whose gradients
    in the two runs share a sign (the whole-model figure keeps them all).
    Returns the launches of the counted steps."""
    import math

    from apex_tpu_torch.kernels import registry
    params = dict(model.named_parameters())
    w0 = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    expected = {**dict.fromkeys(registry.launches(), 0), **per_step}
    if backward is None:
        def backward(loss, opt):
            loss.backward()
    if held is None:
        def held(opt):
            return params

    def step(opt):
        loss = loss_of()
        backward(loss, opt)
        if sync is not None:
            sync(None)
        with step_guard():
            opt.step()
        opt.zero_grad()
        return loss

    totals = dict.fromkeys(expected, 0)
    opt = make_opt(model.parameters())
    losses, step_ms = [], []
    for k in range(COUNTED_STEPS):
        registry.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_of()
        backward(loss, opt)
        if k == 0 and hold_plain:
            g1 = {n: p.grad.detach().to("cpu", copy=True)
                  for n, p in params.items()}
        if sync is not None:
            sync(k)
        with step_guard():
            opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = registry.launches()
        assert launches == expected, (k, launches, expected)
        for name in expected:
            totals[name] += launches[name]
        assert torch.isfinite(loss), loss
        losses.append(loss.item())
        if k == 0:
            p1 = {n: p.detach().to("cpu", copy=True)
                  for n, p in held(opt).items()}
            moved = sum(not torch.equal(p1[n], w0[n].to(p1[n].dtype))
                        for n in params)
            assert moved == len(params), (moved, len(params))
    assert opt.param_groups[0]["step"] == COUNTED_STEPS
    log(f"{label}: {COUNTED_STEPS} steps: losses {losses}; launches per step "
        f"{ {k: v for k, v in per_step.items() if v} } (every step; every "
        f"other kernel 0), {len(params)} tensors, {n_params} params; step "
        f"ms {step_ms}")
    assert losses[-1] < losses[falls_from], f"the loss did not fall: {losses}"

    # step time, throughput, peak memory through the same entry points
    torch.cuda.reset_peak_memory_stats()
    timed, timed_losses = [], []
    for _ in range(TIMED_STEPS):
        ms, loss = _wall_ms(lambda: step(opt))
        timed.append(ms)
        timed_losses.append(loss.item())
    med = statistics.median(timed)
    count, unit = work
    log(f"{label}: step (forward, backward, {type(opt).__name__}) "
        f"{_spread(timed)} = {count / med * 1e3:.1f} {unit}/s (host clock, "
        f"synchronized); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses of "
        f"steps {COUNTED_STEPS + 1}-{COUNTED_STEPS + TIMED_STEPS}: "
        f"{timed_losses}")
    stats = profile_window(f"{label} step", lambda: step(opt), top=10,
                           watch=PROFILE_WATCH if watch is None else watch,
                           ranges=ranges)
    if record is not None:
        record.update(losses=losses, timed_ms=med, profile=stats,
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not hold_plain:
        return totals

    # step 1 again from the same weights, through the plain versions
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w0[n])
    opt = make_opt(model.parameters())
    registry.reset()
    with plain_versions():
        loss = loss_of()
        backward(loss, opt)
        grad_err = {n: _rel_fro(g1[n].cuda(), p.grad)
                    for n, p in params.items()}
        agree = ({n: torch.sign(g1[n].cuda()) == torch.sign(p.grad)
                  for n, p in params.items()} if same_sign_tensors else {})
        opt.step()
        opt.zero_grad()
    moved_to = held(opt)
    assert not any(registry.launches().values()), registry.launches()
    loss_err = abs(losses[0] - loss.item()) / abs(loss.item())
    num = den = num1 = den1 = flipped = flipped_linear = 0.0
    below = None if linear_below is None else linear_below(g1)
    update_err = {}
    for n in params:
        want = moved_to[n].detach() - w0[n].cuda().to(moved_to[n].dtype)
        got = p1[n].cuda() - w0[n].cuda().to(p1[n].dtype)
        mask = agree.get(n)
        update_err[n] = (_rel_fro(got, want) if mask is None
                         else _rel_fro(got[mask], want[mask]))
        num += (got - want).float().norm().item() ** 2
        den += want.float().norm().item() ** 2
        flip = torch.sign(got) != torch.sign(want)
        flipped += flip.sum().item()
        num1 += (got - want)[~flip].float().norm().item() ** 2
        den1 += want[~flip].float().norm().item() ** 2
        if below is not None:
            flipped_linear += (flip & (g1[n].cuda().abs() < below)).sum().item()
    total_err = math.sqrt(num / den)
    worst_g = max(grad_err, key=grad_err.get)
    worst_u = max(update_err, key=update_err.get)
    log(f"{label}: step 1 kernels vs plain versions: loss {losses[0]:.6f} "
        f"vs {loss.item():.6f} (rel err {loss_err:.3e}, tolerance "
        f"{TRAIN_LOSS_RTOL}); largest gradient rel err {grad_err[worst_g]:.3e}"
        f" ({worst_g}; tolerance {TRAIN_GRAD_RTOL}); update rel err "
        f"{total_err:.3e} over all parameters (tolerance "
        f"{update_rtol[0]}), largest {update_err[worst_u]:.3e} "
        f"({worst_u}{', over its entries whose gradients share a sign' if agree else ''}; "
        f"tolerance {update_rtol[1]}); updates of opposite "
        f"sign: {flipped / n_params:.3e} of the entries (2*sqrt "
        f"{2 * math.sqrt(flipped / n_params):.3e}); update rel err over the "
        f"entries of one sign {math.sqrt(num1 / den1):.3e}"
        + ("" if below is None else
           f"; of the flipped entries {flipped_linear / max(flipped, 1):.4f} "
           f"have |g| < {below:.3e}, where the update is linear in g"))
    assert loss_err <= TRAIN_LOSS_RTOL, loss_err
    assert grad_err[worst_g] <= TRAIN_GRAD_RTOL, (worst_g, grad_err[worst_g])
    assert total_err <= update_rtol[0], total_err
    assert update_err[worst_u] <= update_rtol[1], (
        worst_u, update_err[worst_u])
    return totals


def _new_model(label, build):
    """``build()`` on the card with seeded random weights, timed."""
    from apex_tpu_torch.models import init_weights
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build()
    init_weights(model, SEED)
    cfg = model.config
    log(f"{label}: {type(model).__name__} {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, vocab "
        f"{cfg.vocab_size}, use_flash_attention={cfg.use_flash_attention}, "
        f"built in {time.perf_counter() - t0:.1f} s; {resident / 2**30:.3f} "
        f"GiB allocated before the model")
    return model


def run_training(label, use_flash, batch, seq):
    """``FusedAdam`` steps of TinyLlama-1.1B (22 layers, seeded random
    weights) on a seeded batch of ``batch`` x ``seq`` tokens, through
    :func:`train_steps`."""
    import math

    from apex_tpu_torch.kernels import optim
    from apex_tpu_torch.models import GPTModel, TransformerConfig, gpt_loss_fn
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16,
                            use_flash_attention=use_flash)
    model = _new_model(label, lambda: GPTModel(cfg))  # on the card
    gen = torch.Generator().manual_seed(SEED + 1)
    shape = (batch, seq)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen).cuda()
    labels = torch.randint(0, cfg.vocab_size, shape, generator=gen).cuda()
    L = cfg.num_layers
    attention = (dict(flash_fwd=L, flash_dq=L, flash_dkv=L) if use_flash
                 else dict(causal_softmax=L, softmax_bwd=L))
    n_tensors = len(list(model.parameters()))
    per_step = {"rms_norm": 2 * L + 1, "rms_bwd": 2 * L + 1, **attention,
                "adam": math.ceil(n_tensors / optim.MAX_TENSORS)}
    return train_steps(
        label, model, lambda: gpt_loss_fn(model(tokens), labels),
        lambda ps: FusedAdam(ps, lr=TRAIN_LR), per_step,
        (batch * seq, "tokens"))


def phase_training():
    return {"training": run_training("training", False, TRAIN_BATCH,
                                     TRAIN_SEQ)}


def phase_flash_training():
    return {"flash_training": run_training("flash training", True,
                                           FLASH_BATCH, FLASH_SEQ)}


def phase_gpt2_training():
    """GPT-2 345M as bench_gpt2 trains it: 8 x 1024 tokens, flash on,
    FusedAdam(lr=1e-4)."""
    import math

    import numpy as np

    from apex_tpu_torch.kernels import optim
    from apex_tpu_torch.models import GPTModel, TransformerConfig, gpt_loss_fn
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = TransformerConfig(**GPT2, compute_dtype=torch.bfloat16,
                            use_flash_attention=True)
    model = _new_model("gpt2 training", lambda: GPTModel(cfg))
    rng = np.random.RandomState(SEED)  # bench_gpt2's batch
    shape = (GPT2_BATCH, GPT2_SEQ)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    L = cfg.num_layers
    n_tensors = len(list(model.parameters()))
    per_step = {"layer_norm": 2 * L + 1, "ln_bwd": 2 * L + 1,
                "flash_fwd": L, "flash_dq": L, "flash_dkv": L,
                "adam": math.ceil(n_tensors / optim.MAX_TENSORS)}
    record = _TRAIN_RECORDS.setdefault("gpt2", {})
    return {"gpt2_training": train_steps(
        "gpt2 training", model, lambda: gpt_loss_fn(model(tokens), labels),
        lambda ps: FusedAdam(ps, lr=GPT2_LR), per_step,
        (GPT2_BATCH * GPT2_SEQ, "tokens"), record=record)}


def phase_bert_training():
    """BERT-large pretraining as bench_bert runs it: 64 x 128 tokens,
    padding mask type with bench_bert's all-ones padding mask, token
    types 0, a 15 % loss mask, MLM + NSP loss, FusedLAMB(lr=1e-3,
    weight_decay=0.01)."""
    import math

    import numpy as np

    from apex_tpu_torch.kernels import optim, registry
    from apex_tpu_torch.models import BertModel, TransformerConfig, bert_loss_fn
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.enums import AttnMaskType
    cfg = TransformerConfig(**BERT, compute_dtype=torch.bfloat16,
                            use_flash_attention=False,
                            attn_mask_type=AttnMaskType.padding)
    model = _new_model("bert training", lambda: BertModel(cfg))
    b, s = BERT_BATCH, BERT_SEQ
    rng = np.random.RandomState(SEED)  # bench_bert's inputs, in its order
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    padding_mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
    tokentype = torch.zeros(b, s, dtype=torch.long, device="cuda")
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    loss_mask = torch.from_numpy(
        (rng.rand(b, s) < 0.15).astype(np.float32)).cuda()
    nsp_labels = torch.from_numpy(rng.randint(0, 2, (b,))).cuda()

    def loss_of():
        mlm, nsp = model(tokens, padding_mask, tokentype)
        assert mlm.shape == (b, s, cfg.vocab_size) and nsp.shape == (b, 2)
        return bert_loss_fn(mlm, nsp, labels, loss_mask, nsp_labels)

    L = cfg.num_layers
    n_tensors = len(list(model.parameters()))
    per_step = {"layer_norm": 2 * L + 2, "ln_bwd": 2 * L + 2,
                "masked_softmax": L, "softmax_bwd": L,
                "lamb": math.ceil(n_tensors / optim.MAX_TENSORS),
                "lamb_stage2": math.ceil(n_tensors / optim.MAX_TENSORS)}

    def lamb_linear_below(g1):
        """|g| < eps * clip is |h| < eps for h = g / clip, the clipped
        gradient of LAMB's first update h / (|h| + eps) + wd * p."""
        norm = math.sqrt(sum(g.cuda().double().square().sum().item()
                             for g in g1.values()))
        return BERT_EPS * max(norm / BERT_MAX_GRAD_NORM, 1.0)

    # bench_bert's LAMB (lr 1e-3, no warmup) overshoots at step 2 from a
    # random init, in JAX as in the port (tests/test_torch_bert.py pins
    # it at a reduced size); the loss must fall from step 2 on
    totals = train_steps(
        "bert training", model, loss_of,
        lambda ps: FusedLAMB(ps, lr=BERT_LR, weight_decay=BERT_WD,
                             eps=BERT_EPS, max_grad_norm=BERT_MAX_GRAD_NORM),
        per_step, (b, "samples"),
        update_rtol=(LAMB_UPDATE_RTOL, LAMB_TENSOR_UPDATE_RTOL), falls_from=1,
        linear_below=lamb_linear_below,
        record=_TRAIN_RECORDS.setdefault("bert", {}))

    # a path of its own, counted from its own reset: no padding mask, so
    # the padding mask type takes the scaled softmax kernel (#8) in place
    # of the masked one, and with nothing masked gives the same loss (bit
    # for bit expected; held within 1e-6)
    registry.reset()
    torch.cuda.synchronize()
    mlm, nsp = model(tokens, None, tokentype)
    loss_none = bert_loss_fn(mlm, nsp, labels, loss_mask, nsp_labels)
    loss_none.backward()
    torch.cuda.synchronize()
    launches = registry.launches()
    expected = {**dict.fromkeys(launches, 0), "layer_norm": 2 * L + 2,
                "ln_bwd": 2 * L + 2, "scaled_softmax": L, "softmax_bwd": L}
    assert launches == expected, (launches, expected)
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        loss_ones = loss_of()
    log(f"bert training: forward + backward without a padding mask: "
        f"launches { {k: v for k, v in launches.items() if v} }; loss "
        f"{loss_none.item():.6f}, with the all-ones mask {loss_ones.item():.6f}")
    assert abs(loss_none.item() - loss_ones.item()) <= 1e-6 * abs(
        loss_ones.item()), (loss_none, loss_ones)
    return {"bert_training": totals, "bert_no_mask": launches}


# ------------------------------------------------------- the amp phases

# amp O1 + FusedSGD (BASELINE.json's "amp O1 + FusedSGD") on GPT-2 345M:
# momentum 0.9 and a learning rate under which a 2-layer GPT-2-width
# model's loss falls steadily on a fixed batch (0.1 falls faster there)
AMP_SGD_LR = 0.03
# the step at which each amp phase plants an inf in one gradient
AMP_OVERFLOW_STEP = 2
# The amp phases hold each tensor's step-1 update (TRAIN_TENSOR_UPDATE_RTOL,
# LAMB's for BERT) over the entries whose gradients in the kernel and plain
# runs share a sign (train_steps' same_sign_tensors; the whole-model figure
# keeps every entry): under O2 the key third of a QKV bias has an exact
# zero gradient, which bf16 roundings turn into noise of either sign, and
# Adam's sign-like first step moves those entries by +-lr in each run on
# its own (0.537 over the whole of layer 0's QKV bias on an H100). A
# missing or wrong update still reads 1 or more over the agreeing entries.
# the fp32 phases' records, for the amp phases to print beside theirs
_TRAIN_RECORDS = {}


@contextlib.contextmanager
def _no_host_sync():
    """The host may not wait for the device inside the block: any
    synchronising call raises (torch.cuda.set_sync_debug_mode)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _amp_groups(model, *names):
    """Launches a step of each kernel named, for a model whose parameters
    group by dtype (one launch per MAX_TENSORS tensors of a dtype)."""
    from apex_tpu_torch.kernels import optim
    counts = {}
    for p in model.parameters():
        counts[p.dtype] = counts.get(p.dtype, 0) + 1
    per = sum(math.ceil(c / optim.MAX_TENSORS) for c in counts.values())
    return dict.fromkeys(names, per)


def _masters(key):
    """held(opt) for train_steps: the fp32 masters under state ``key``."""
    def held(opt):
        inner = opt.inner
        return {n: inner.state[p][key] for n, p in _NAMED.items()}
    return held


_NAMED = {}  # the amp phase's model's named parameters


def _amp_snapshot(opt, params):
    """Copies of everything a skipped step must leave: the parameters,
    every state tensor (moments, masters, momentum), the step counts."""
    out = [p.detach().clone() for p in params]
    for p in params:
        out += [v.clone() for _, v in sorted(opt.state[p].items())
                if isinstance(v, torch.Tensor)]
    out += [g["step"].clone() for g in opt.param_groups]
    return out


def _amp_overflow_check(label, model, loss_of, make_opt):
    """A fresh optimizer takes AMP_OVERFLOW_STEP steps; at the last an inf
    is written into one gradient after backward. That step must leave the
    parameters, masters, moments and step counts bit-identical and halve
    the scale (2^16 to 2^15); every opt.step() runs with host waits
    forbidden."""
    params = list(model.parameters())
    kept = [p.detach().clone() for p in params]  # restored after the check
    opt = make_opt(params)
    victim = params[len(params) // 2]
    for k in range(1, AMP_OVERFLOW_STEP + 1):
        loss = loss_of()
        opt.scale_loss(loss).backward()
        if k == AMP_OVERFLOW_STEP:
            before = _amp_snapshot(opt, params)
            scale = opt.scaler._state.loss_scale.item()
            victim.grad.view(-1)[victim.numel() // 3] = float("inf")
        with _no_host_sync():
            opt.step()
        opt.zero_grad()
    after = _amp_snapshot(opt, params)
    same = _equal_lists(after, before)
    new_scale = opt.scaler._state.loss_scale.item()
    found = opt.last_found_inf.item()
    steps = [int(g["step"].reshape(-1)[0]) for g in opt.param_groups]
    log(f"{label}: an inf planted in one gradient at step "
        f"{AMP_OVERFLOW_STEP}: found_inf {found}; parameters, masters, "
        f"moments and step counts ({steps}) bit-identical after the step: "
        f"{same} ({len(before)} tensors); loss scale {scale} -> {new_scale}; "
        f"opt.step() ran with host waits forbidden")
    assert found == 1.0 and same, (found, same)
    assert steps == [AMP_OVERFLOW_STEP - 1] * len(steps), steps
    assert scale == 2.0 ** 16 and new_scale == 2.0 ** 15, (scale, new_scale)
    with torch.no_grad():  # the counted steps start from the initial weights
        for p, w in zip(params, kept):
            p.copy_(w)
    del opt, before, after, kept
    _amp_release()


def _amp_release():
    """Drop what amp.initialize keeps (its optimizers and their state)."""
    from apex_tpu_torch import amp
    amp._amp_state.reset()
    torch.cuda.empty_cache()


def _amp_beside(label, record, fp32_key, unit):
    """The amp step's numbers beside the fp32 phase's of the same run."""
    fp32 = _TRAIN_RECORDS.get(fp32_key)
    prof = record.get("profile") or {}
    busy = (prof["busy_us"] / prof["span_us"]) if prof else None
    text = (f"{label}: step median {record['timed_ms']:.2f} ms, peak "
            f"{record['peak_gib']:.2f} GiB, busy "
            f"{'not measured' if busy is None else f'{busy:.3f}'}")
    if fp32 is not None:
        text += (f"; the fp32-parameter {fp32_key} step of this run "
                 f"{fp32['timed_ms']:.2f} ms, peak {fp32['peak_gib']:.2f} "
                 f"GiB: {fp32['timed_ms'] / record['timed_ms']:.3f}x the "
                 f"{unit}/s")
    log(text)


def _bf16_gemm_case(gen, m, k, n):
    """Operands of a bf16 GEMM, its fp32 sum rounded once to bf16 (JAX's
    ``matmul(preferred_element_type=f32).astype(bf16)``) and the limit:
    one bf16 ulp of that plus 2 (k - 1) * 2^-24 * (|x| @ |w|), what two
    fp32 sums of the k (exact) products in different orders can differ
    by."""
    x = _randn(gen, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    want = (x.float() @ w.float()).bfloat16().float()
    _, exp = torch.frexp(want)
    limit = (torch.ldexp(torch.ones_like(want), exp - 8)  # a bf16 ulp
             + 2 * (k - 1) * 2.0 ** -24
             * (x.float().abs() @ w.float().abs()))
    return x, w, want, limit


def _gemm_reading(got, want, limit):
    """(largest |got - want| / limit, share of entries that differ)."""
    got = got.float()
    return ((got - want).abs() / limit).max().item(), (
        (got != want).float().mean().item())


def _bf16_gemm_rounding(label, m=GPT2_BATCH * GPT2_SEQ, k=1024, n=4096):
    """amp's linears multiply bf16 by bf16 into bf16, which JAX rounds
    once from an fp32 sum; amp.initialize turns off cuBLAS's bf16
    reduced-precision reduction for it. Held, after amp.initialize:
    torch.matmul's bf16 result within _bf16_gemm_case's limit, at GPT-2
    345M's dense_h_to_4h shape (8 x 1024 tokens). The check must catch a
    double rounding: the same product as 4 split-K partial sums, each
    rounded to bf16 and then summed (what a reduced-precision split-K
    does), must read past the limit. The readings with the reduction
    allowed, at this shape and at a split-K shape (few rows, a long k),
    are printed beside them (cuBLAS's choice, not held)."""
    cuda_matmul = torch.backends.cuda.matmul
    assert not cuda_matmul.allow_bf16_reduced_precision_reduction, (
        "amp.initialize leaves bf16 reduced-precision reduction on")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x, w, want, limit = _bf16_gemm_case(gen, m, k, n)
    held, share = _gemm_reading(torch.matmul(x, w), want, limit)
    parts = sum(torch.matmul(x[:, c], w[c]).float()
                for c in torch.arange(k, device="cuda").chunk(4))
    planted, _ = _gemm_reading(parts.bfloat16(), want, limit)
    readings = []
    for shape in ((m, k, n), (64, 16384, 64)):
        xs, ws, wants, limits = (x, w, want, limit) if shape == (m, k, n) \
            else _bf16_gemm_case(gen, *shape)
        row = []
        for allowed in (False, True):
            cuda_matmul.allow_bf16_reduced_precision_reduction = allowed
            try:
                row.append(_gemm_reading(torch.matmul(xs, ws), wants, limits))
            finally:
                cuda_matmul.allow_bf16_reduced_precision_reduction = False
        readings.append((shape, row))
    log(f"{label}: bf16 GEMM [{m}, {k}] x [{k}, {n}] against the fp32 sum "
        f"rounded once: {held:.4f} of the limit (one bf16 ulp + the fp32 "
        f"order bound), {share:.3e} of the entries differ; the planted "
        f"double rounding (4 split-K partial sums rounded to bf16) "
        f"{planted:.4f}: {'caught' if planted > 1.0 else 'NOT caught'}; "
        + "; ".join(f"{list(sh)} off/on {a[0]:.4f}/{b[0]:.4f}"
                    for sh, (a, b) in readings)
        + " (reduced-precision reduction off/allowed: cuBLAS's choice)")
    assert held <= 1.0, held
    assert planted > 1.0, planted


def _gpt2_batch(cfg):
    import numpy as np
    rng = np.random.RandomState(SEED)  # bench_gpt2's batch
    shape = (GPT2_BATCH, GPT2_SEQ)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    return tokens, labels


def _amp_gpt2_run(label, opt_level, make_inner, kernels, held):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTModel, TransformerConfig, gpt_loss_fn
    cfg = TransformerConfig(**GPT2, compute_dtype=torch.bfloat16,
                            use_flash_attention=True)
    model = _new_model(label, lambda: GPTModel(cfg))
    amp.initialize(model, None, opt_level=opt_level, verbosity=0)
    if opt_level == "O2":
        _bf16_gemm_rounding(label)
    _NAMED.clear()
    _NAMED.update(model.named_parameters())
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    log(f"{label}: amp {opt_level}: parameter dtypes {dtypes}, "
        f"{sum(p.dtype == torch.float32 for p in model.parameters())} "
        f"fp32 tensors (the norms' under O2)")
    tokens, labels = _gpt2_batch(cfg)

    def loss_of():
        return gpt_loss_fn(model(tokens), labels)

    def make_opt(ps):
        return amp.initialize(model, make_inner(ps), opt_level=opt_level,
                              verbosity=0)[1]

    _amp_overflow_check(label, model, loss_of, make_opt)
    L = cfg.num_layers
    per_step = {"layer_norm": 2 * L + 1, "ln_bwd": 2 * L + 1,
                "flash_fwd": L, "flash_dq": L, "flash_dkv": L,
                **_amp_groups(model, "multi_tensor_scale", *kernels)}
    record = {}
    totals = train_steps(
        label, model, loss_of, make_opt, per_step,
        (GPT2_BATCH * GPT2_SEQ, "tokens"),
        backward=lambda loss, opt: opt.scale_loss(loss).backward(),
        held=held, step_guard=_no_host_sync, record=record,
        same_sign_tensors=True)
    _amp_beside(label, record, "gpt2", "tokens")
    amp.initialize(model, None, enabled=False)  # the O1 policy off again
    _NAMED.clear()
    _amp_release()
    return totals


def phase_amp_gpt2():
    """GPT-2 345M as bench_gpt2 trains it, under amp O2 as bench.py's
    bench_resnet drives amp (bench.py:1242): amp.initialize(model,
    FusedAdam(lr=1e-4), opt_level="O2"), fp32 masters owned by amp, the
    dynamic scale."""
    from apex_tpu_torch.optimizers import FusedAdam
    return {"amp_gpt2": _amp_gpt2_run(
        "amp gpt2", "O2", lambda ps: FusedAdam(ps, lr=GPT2_LR), ("adam",),
        _masters("amp_master"))}


def phase_amp_o1_sgd():
    """The same model under amp O1 with FusedSGD(lr, momentum=0.9):
    BASELINE.json's "amp O1 + FusedSGD" (parameters fp32, the dtype policy
    on, which the port's models do not consult, as JAX's do not)."""
    from apex_tpu_torch.optimizers import FusedSGD
    return {"amp_o1_sgd": _amp_gpt2_run(
        "amp o1 sgd", "O1",
        lambda ps: FusedSGD(ps, lr=AMP_SGD_LR, momentum=0.9), ("sgd",),
        None)}


def phase_amp_bert():
    """BERT-large as bench_bert trains it (phase 7's inputs), under amp O2
    with FusedMixedPrecisionLamb(lr=1e-3, weight_decay=0.01) and
    bench_bert's eps and clip, its own fp32 masters."""
    import numpy as np

    from apex_tpu_torch import amp
    from apex_tpu_torch.models import BertModel, TransformerConfig, bert_loss_fn
    from apex_tpu_torch.optimizers import FusedMixedPrecisionLamb
    from apex_tpu_torch.transformer.enums import AttnMaskType
    label = "amp bert"
    cfg = TransformerConfig(**BERT, compute_dtype=torch.bfloat16,
                            use_flash_attention=False,
                            attn_mask_type=AttnMaskType.padding)
    model = _new_model(label, lambda: BertModel(cfg))
    amp.initialize(model, None, opt_level="O2", verbosity=0)
    _NAMED.clear()
    _NAMED.update(model.named_parameters())
    log(f"{label}: amp O2: "
        f"{sum(p.dtype == torch.float32 for p in model.parameters())} fp32 "
        f"tensors (the norms'), "
        f"{sum(p.dtype == torch.bfloat16 for p in model.parameters())} bf16")
    b, s = BERT_BATCH, BERT_SEQ
    rng = np.random.RandomState(SEED)  # bench_bert's inputs, in its order
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    padding_mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
    tokentype = torch.zeros(b, s, dtype=torch.long, device="cuda")
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
    loss_mask = torch.from_numpy(
        (rng.rand(b, s) < 0.15).astype(np.float32)).cuda()
    nsp_labels = torch.from_numpy(rng.randint(0, 2, (b,))).cuda()

    def loss_of():
        mlm, nsp = model(tokens, padding_mask, tokentype)
        return bert_loss_fn(mlm, nsp, labels, loss_mask, nsp_labels)

    def make_opt(ps):
        return amp.initialize(model, FusedMixedPrecisionLamb(
            ps, lr=BERT_LR, weight_decay=BERT_WD, eps=BERT_EPS,
            max_grad_norm=BERT_MAX_GRAD_NORM), opt_level="O2",
            verbosity=0)[1]

    _amp_overflow_check(label, model, loss_of, make_opt)
    L = cfg.num_layers
    per_step = {"layer_norm": 2 * L + 2, "ln_bwd": 2 * L + 2,
                "masked_softmax": L, "softmax_bwd": L,
                **_amp_groups(model, "multi_tensor_scale", "lamb",
                              "lamb_stage2")}
    record = {}
    # bench_bert's LAMB overshoots at step 2 (phase 7): the loss must fall
    # from step 2 on
    totals = train_steps(
        label, model, loss_of, make_opt, per_step, (b, "samples"),
        update_rtol=(LAMB_UPDATE_RTOL, LAMB_TENSOR_UPDATE_RTOL), falls_from=1,
        backward=lambda loss, opt: opt.scale_loss(loss).backward(),
        held=_masters("master"), step_guard=_no_host_sync, record=record,
        same_sign_tensors=True)
    _amp_beside(label, record, "bert", "samples")
    _NAMED.clear()
    _amp_release()
    return {"amp_bert": totals}


# ------------------------------------- the rest of the optimizers' phases

def _gpt2_optimizer_run(label, make_opt, kernels, half=False, held=None,
                        backward=None, before=None, same_sign=None):
    """GPT-2 345M at full width and depth as phase_gpt2_training trains it
    (8 x 1024 tokens, flash on) with ``make_opt``'s optimizer; its kernels'
    launches a step from the model's parameter groups (``kernels``:
    names); every opt.step() with host waits forbidden; the model bf16
    from fp16util.network_to_half where ``half``; ``before(model,
    loss_of, make_opt)`` runs first (the overflow check); ``same_sign``
    (default: ``half``) holds each tensor's step-1 update over the entries
    whose gradients share a sign (train_steps' same_sign_tensors)."""
    from apex_tpu_torch import fp16_utils
    from apex_tpu_torch.models import GPTModel, TransformerConfig, gpt_loss_fn
    cfg = TransformerConfig(**GPT2, compute_dtype=torch.bfloat16,
                            use_flash_attention=True)
    model = _new_model(label, lambda: GPTModel(cfg))
    if half:
        fp16_utils.network_to_half(model)
        log(f"{label}: network_to_half: "
            f"{sum(p.dtype == torch.float32 for p in model.parameters())} "
            f"fp32 tensors (the norms'), "
            f"{sum(p.dtype == torch.bfloat16 for p in model.parameters())} "
            f"bf16")
    _NAMED.clear()
    _NAMED.update(model.named_parameters())
    tokens, labels = _gpt2_batch(cfg)

    def loss_of():
        return gpt_loss_fn(model(tokens), labels)

    if before is not None:
        before(label, model, loss_of, make_opt)
    L = cfg.num_layers
    per_step = {"layer_norm": 2 * L + 1, "ln_bwd": 2 * L + 1,
                "flash_fwd": L, "flash_dq": L, "flash_dkv": L,
                **_amp_groups(model, *kernels)}
    record = {}
    totals = train_steps(
        label, model, loss_of, make_opt, per_step,
        (GPT2_BATCH * GPT2_SEQ, "tokens"), backward=backward, held=held,
        step_guard=_no_host_sync, record=record,
        same_sign_tensors=half if same_sign is None else same_sign)
    _amp_beside(label, record, "gpt2", "tokens")
    _NAMED.clear()
    del model
    torch.cuda.empty_cache()
    return totals


def phase_novograd_gpt2():
    """GPT-2 345M with FusedNovoGrad (NOVOGRAD_LR, NOVOGRAD_BETAS,
    NOVOGRAD_WD, L2 norms, decoupled decay): K6, two CUDA kernels a table,
    the second moments on the device."""
    from apex_tpu_torch.optimizers import FusedNovoGrad
    return {"novograd_gpt2": _gpt2_optimizer_run(
        "novograd gpt2", lambda ps: FusedNovoGrad(
            ps, lr=NOVOGRAD_LR, betas=NOVOGRAD_BETAS,
            weight_decay=NOVOGRAD_WD), ("novograd",))}


def phase_adagrad_gpt2():
    """GPT-2 345M with FusedAdagrad(lr=ADAGRAD_LR): K5. Its first step is
    sign-like, g / (|g| + eps) with eps 1e-10, as amp's Adam steps are, so
    each tensor's step-1 update is held over the entries whose gradients
    in the two runs share a sign (the QKV bias's key third, an exact zero
    gradient in fp32 that bf16 roundings turn into noise of either sign,
    read 0.456 of the limit over every entry on an H100); the whole-model
    figure keeps every entry."""
    from apex_tpu_torch.optimizers import FusedAdagrad
    return {"adagrad_gpt2": _gpt2_optimizer_run(
        "adagrad gpt2", lambda ps: FusedAdagrad(ps, lr=ADAGRAD_LR),
        ("adagrad",), same_sign=True)}


def _fp16_masters(opt):
    """held(opt) for train_steps: FP16_Optimizer's fp32 masters, by the
    names of their model parameters."""
    master_of = dict(zip(map(id, opt.model_params), opt.masters))
    return {n: master_of[id(p)] for n, p in _NAMED.items()}


def _fp16_snapshot(opt):
    """Copies of what a skipped FP16_Optimizer step must leave: the
    parameters, the masters, the inner state and the step counts."""
    out = [t.detach().clone() for t in opt.model_params + opt.masters]
    for m in opt.masters:
        out += [v.clone() for _, v in sorted(opt.state[m].items())
                if isinstance(v, torch.Tensor)]
    return out + [g["step"].clone() for g in opt.param_groups]


def _fp16_overflow_check(label, model, loss_of, make_opt):
    """A fresh FP16_Optimizer takes AMP_OVERFLOW_STEP steps; at the last an
    inf is written into one model gradient after backward, and
    update_master_grads (its one host read) sees the overflow and halves
    the scale; the step after it must leave the parameters, masters,
    moments and step counts bit-identical, with host waits forbidden."""
    params = list(model.parameters())
    kept = [p.detach().clone() for p in params]  # restored after the check
    opt = make_opt(params)
    victim = params[len(params) // 2]
    for k in range(1, AMP_OVERFLOW_STEP + 1):
        opt.backward(loss_of())
        if k == AMP_OVERFLOW_STEP:
            before = _fp16_snapshot(opt)
            scale = opt.loss_scale
            victim.grad.view(-1)[victim.numel() // 3] = float("inf")
            opt.update_master_grads()
        with _no_host_sync():
            opt.step()
        opt.zero_grad()
    after = _fp16_snapshot(opt)
    same = _equal_lists(after, before)
    steps = [int(g["step"].reshape(-1)[0]) for g in opt.param_groups]
    log(f"{label}: an inf planted in one gradient at step "
        f"{AMP_OVERFLOW_STEP}: update_master_grads' overflow "
        f"{opt.overflow}; parameters, masters, moments and step counts "
        f"({steps}) bit-identical after the step: {same} ({len(before)} "
        f"tensors); loss scale {scale} -> {opt.loss_scale}; opt.step() ran "
        f"with host waits forbidden")
    assert opt.overflow and same, (opt.overflow, same)
    assert steps == [AMP_OVERFLOW_STEP - 1] * len(steps), steps
    assert opt.loss_scale == scale / 2, (scale, opt.loss_scale)
    with torch.no_grad():  # the counted steps start from the initial weights
        for p, w in zip(params, kept):
            p.copy_(w)
    del opt, before, after, kept
    torch.cuda.empty_cache()


def phase_fp16_gpt2():
    """GPT-2 345M in bf16 from fp16util.network_to_half (the norms' fp32)
    with FP16_Optimizer(FusedAdam(lr=GPT2_LR), dynamic_loss_scale=True):
    the loss scaled by 2^32, K1 unscaling the bf16 gradients into the fp32
    masters' with the overflow flag, #12 stepping the masters and writing
    the parameters from them in the same pass."""
    from apex_tpu_torch.fp16_utils import FP16_Optimizer
    from apex_tpu_torch.optimizers import FusedAdam
    return {"fp16_gpt2": _gpt2_optimizer_run(
        "fp16 gpt2", lambda ps: FP16_Optimizer(
            FusedAdam(ps, lr=GPT2_LR), dynamic_loss_scale=True),
        ("multi_tensor_scale", "adam"), half=True, held=_fp16_masters,
        backward=lambda loss, opt: opt.backward(loss),
        before=_fp16_overflow_check)}


def phase_mha():
    """SelfMultiheadAttn at BERT-large width, forward and backward, bf16
    weights and activations, no dropout: the non-causal flash path;
    then the same with ``include_norm_add=True`` (LayerNorm on the fp32
    query, cast back, and the residual add)."""
    from apex_tpu_torch.contrib import SelfMultiheadAttn
    from apex_tpu_torch.kernels import registry
    totals = {}
    for norm_add in (False, True):
        torch.manual_seed(SEED)
        mha = SelfMultiheadAttn(MHA_HIDDEN, MHA_HEADS, bias=True, impl="fast",
                                include_norm_add=norm_add,
                                param_dtype=torch.bfloat16)  # on the card
        if norm_add:  # a LayerNorm that is not the identity
            gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
            with torch.no_grad():
                mha.lyr_norm.weight.add_(0.1 * torch.randn(
                    MHA_HIDDEN, generator=gen, device="cuda"))
                mha.lyr_norm.bias.add_(0.1 * torch.randn(
                    MHA_HIDDEN, generator=gen, device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        x = _randn(gen, MHA_SEQ, MHA_BATCH, MHA_HIDDEN)
        dy = _randn(gen, MHA_SEQ, MHA_BATCH, MHA_HIDDEN)
        params = dict(mha.named_parameters())

        def fwd_bwd():
            xg = x.detach().requires_grad_()
            out = mha(xg)
            grads = torch.autograd.grad(out, (xg, *params.values()), dy)
            return out, dict(zip(("x", *params), grads))

        registry.reset()
        torch.cuda.synchronize()
        out, grads = fwd_bwd()
        torch.cuda.synchronize()
        launches = registry.launches()
        expected = {**dict.fromkeys(launches, 0),
                    "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                    "layer_norm": int(norm_add), "ln_bwd": int(norm_add)}
        assert launches == expected, (launches, expected)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
        assert torch.isfinite(out).all()
        with plain_versions():
            out_p, grads_p = fwd_bwd()
        errs = {"out": _rel_fro(out, out_p),
                **{n: _rel_fro(grads[n], grads_p[n]) for n in grads}}
        worst = max(errs, key=errs.get)
        ms = call_ms(fwd_bwd, 10, 2)
        log(f"mha: SelfMultiheadAttn(h {MHA_HIDDEN}, {MHA_HEADS} heads, "
            f"bf16, fast, include_norm_add={norm_add}) on [{MHA_SEQ}, "
            f"{MHA_BATCH}, {MHA_HIDDEN}]: launches "
            f"{ {k: v for k, v in launches.items() if v} }; kernels vs plain "
            f"versions: output rel err {errs['out']:.3e}, largest "
            f"{errs[worst]:.3e} ({worst}; tolerance {MHA_RTOL}); forward + "
            f"backward {ms:.3f} ms (CUDA events, eager)")
        assert errs[worst] <= MHA_RTOL, (worst, errs[worst])
        totals = {k: totals.get(k, 0) + v for k, v in launches.items()}
    return {"mha": totals}


# ---------------------------------------------------------- serve phases

def _serve_trace(vocab, n=SERVE_REQUESTS, seed=SERVE_SEED):
    from apex_tpu_torch.serving import synthetic_trace
    return synthetic_trace(n, seed=seed, mean_interarrival=1.0,
                           prompt_lens=SERVE_PROMPT_LENS,
                           max_new=SERVE_MAX_NEW, vocab_size=vocab)


def _streams(completed):
    return {c.rid: c.tokens.tolist() for c in completed}


def _margin_check(label, model, trace, got, want):
    """Token streams ``got`` against ``want`` (each {rid: tokens}): where
    a stream differs, the top-2 margin of ``want``'s model logits at the
    first differing position (the prompt and ``want``'s tokens before it,
    prefilled through the kernels) must be below LOGIT_TOL and ``got``'s
    token one of the two: a near tie that an fp32 difference in the last
    place may break either way, not a wrong token."""
    from apex_tpu_torch.models import init_cache, prefill
    same = 0
    for r in trace:
        a, b = got[r.rid], want[r.rid]
        if a == b:
            same += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = torch.as_tensor(list(r.prompt) + b[:i],
                              device=model.device)[None]
        _, logits = prefill(model, init_cache(model, 1), ctx, torch.arange(
            ctx.shape[1], device=model.device)[None])
        top = torch.topk(logits[0].float(), 2)
        margin = (top.values[0] - top.values[1]).item()
        log(f"{label}: request {r.rid} first differs at generated token {i} "
            f"({a[i]} vs {b[i]}); top-2 logit margin there {margin:.4f} "
            f"(tolerance {LOGIT_TOL}), top-2 tokens {top.indices.tolist()}")
        assert margin < LOGIT_TOL and a[i] in top.indices.tolist(), (
            label, r.rid, i, margin)
    log(f"{label}: {same} of {len(trace)} streams identical")


def _serve_counted(label, engine, vocab, trace=None, warm=None,
                   before=None):
    """Warm the engine on a short trace (``warm``), then drive the serving
    trace (``trace``) through ``engine.serve`` with every launch count set
    to 0 just before (and ``before()`` called, where given) and read just
    after. Returns (streams, stats, launches)."""
    from apex_tpu_torch.kernels import registry
    # warm: cuBLAS, the allocator
    engine.serve(warm or _serve_trace(vocab, n=4, seed=0))
    trace = trace or _serve_trace(vocab)
    # host clock of each engine call (a call ends with its one read of
    # the sampled tokens, so it spans the device's work too); instance
    # attributes shadow the methods for this run only
    # and the CPU time of this thread in it (the wait for the device
    # spins, so CPU time well below the host clock means the thread was
    # not running: other work held the host's cores)
    calls = {"prefill": [], "decode": [], "decode_cpu": []}

    def timed(name, fn):
        def run(*args, **kw):
            t, c = time.perf_counter(), time.thread_time()
            out = fn(*args, **kw)
            calls[name].append(time.perf_counter() - t)
            if name == "decode":
                calls["decode_cpu"].append(time.thread_time() - c)
            return out
        return run

    engine.prefill = timed("prefill", engine.prefill)
    engine.decode = timed("decode", engine.decode)
    log(f"{label}: card before the run: {card_state()}; host load "
        f"{os.getloadavg()} on {len(os.sched_getaffinity(0))} cores")
    mem0 = torch.cuda.memory_stats()
    registry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if before is not None:
        before()
    t0 = time.perf_counter()
    done, stats = engine.serve(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = registry.launches()
    del engine.prefill, engine.decode
    mem1 = torch.cuda.memory_stats()
    log(f"{label}: card after the run: {card_state()}; host load "
        f"{os.getloadavg()}")
    steps = sorted(calls["decode"])
    cpu = sum(calls["decode_cpu"])
    log(f"{label}: host time {wall * 1e3:.2f} ms = decode calls "
        f"{sum(steps) * 1e3:.2f} ({len(steps)}: median "
        f"{statistics.median(steps) * 1e3:.2f}, p10 "
        f"{steps[len(steps) // 10] * 1e3:.2f}, p90 "
        f"{steps[len(steps) * 9 // 10] * 1e3:.2f} ms) + prefill calls "
        f"{sum(calls['prefill']) * 1e3:.2f} ({len(calls['prefill'])}) + "
        f"scheduler {(wall - sum(steps) - sum(calls['prefill'])) * 1e3:.2f}; "
        f"the decode calls' thread CPU time {cpu * 1e3:.2f} ms "
        f"({cpu / sum(steps):.3f} of their host time); "
        f"allocator during the run: "
        + ", ".join(f"{k} +{mem1.get(k, 0) - mem0.get(k, 0)}" for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries",
            "segment.all.allocated")))
    assert len(done) == len(trace), (len(done), len(trace))
    assert all(c.finish_reason == "length" for c in done), [
        c.finish_reason for c in done]
    want_len = {r.rid: r.max_new_tokens for r in trace}
    assert all(len(c.tokens) == want_len[c.rid] for c in done)
    assert all(0 <= int(t) < vocab for c in done for t in c.tokens)
    extra = (f", acceptance {stats['acceptance_rate']} of "
             f"{stats['spec_proposed']} proposals" if "acceptance_rate"
             in stats else "")
    log(f"{label}: {len(done)} requests, {stats['tokens_generated']} tokens "
        f"in {wall:.2f} s: {stats['tokens_per_sec']:.1f} tokens/s; TTFT p50 "
        f"{stats['ttft_p50_ms']:.2f} ms, p99 {stats['ttft_p99_ms']:.2f} ms; "
        f"per-token latency p50 {stats['tok_latency_p50_ms']:.2f} ms, p99 "
        f"{stats['tok_latency_p99_ms']:.2f} ms; {stats['decode_steps']} "
        f"decode steps, {stats['prefill_calls']} prefill calls{extra}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return _streams(done), stats, launches


def _eager_engine(model, config, **kw):
    """The same engine without its CUDA graphs: its step bodies run
    eagerly on the card, the yardstick the ladder's replays are timed
    against (and at tp > 1, where no graph can capture a gloo collective,
    the engine itself). ``kw`` goes to the engine (``mesh``)."""
    from apex_tpu_torch.serving import ServeEngine

    class EagerEngine(ServeEngine):
        _capture = False

    return EagerEngine(model, config, **kw)


def _ladder_report(label, engine):
    """The engine's ladder: one CUDA graph a bucket, their capture time
    and the shared pool's bytes."""
    ladder = engine.ladder()
    size = len(ladder["decode"]) + len(ladder["prefill"])
    log(f"{label}: {engine.compile_count} CUDA graphs captured (the "
        f"ladder: {len(ladder['decode'])} decode + {len(ladder['prefill'])} "
        f"prefill buckets) in {engine.graph_seconds:.2f} s, warm-ups "
        f"included; the shared pool {engine.graph_pool_bytes / 2**20:.1f} "
        f"MiB")
    assert engine.compile_count == size, (engine.compile_count, size)
    return size


def _beside_eager(label, model, config, vocab, graphed, trace=None,
                  warm=None):
    """The same trace through the same engine run eagerly: its tokens/s
    and a profiled decode call beside the graphs', streams and launch
    counts identical to the graph replays'."""
    streams, stats, launches = graphed
    eager = _eager_engine(model, config)
    e_streams, e_stats, e_launches = _serve_counted(
        f"{label} eager", eager, vocab, trace, warm)
    log(f"{label}: CUDA graphs {stats['tokens_per_sec']:.1f} tokens/s "
        f"against eager calls {e_stats['tokens_per_sec']:.1f} on the same "
        f"trace ({stats['tokens_per_sec'] / e_stats['tokens_per_sec']:.3f}"
        f"x); TTFT p50 {stats['ttft_p50_ms']:.2f} against "
        f"{e_stats['ttft_p50_ms']:.2f} ms; per-token p50 "
        f"{stats['tok_latency_p50_ms']:.2f} against "
        f"{e_stats['tok_latency_p50_ms']:.2f} ms")
    assert e_streams == streams, f"{label}: graph and eager streams differ"
    nonzero = [{k: n for k, n in d.items() if n} for d in (e_launches,
                                                           launches)]
    assert nonzero[0] == nonzero[1], nonzero
    log(f"{label}: all {len(streams)} streams and every launch count "
        f"identical to the eager run's")
    _profile_decode(f"{label} eager decode call (bucket 8)", eager, vocab)
    del eager
    torch.cuda.empty_cache()


def _expect(label, launches, expected):
    expected = {**dict.fromkeys(launches, 0), **expected}
    log(f"{label}: launches {launches}, expected {expected}")
    assert launches == expected, (launches, expected)


def _per_step(label, launches, stats, names, per_prefill):
    """Log the launches of ``names`` a decode step, the prefills' share
    (``per_prefill`` a call) taken out; :func:`_expect` checks them."""
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    log(f"{label}: launches a decode step: " + ", ".join(
        f"{n} {(launches[n] - per_prefill.get(n, 0) * calls) / steps:g}"
        for n in names))


# the serve phases' shared model, and serve_bf16's streams for serve_int8
_SERVE_MODEL = []
_SERVE_STREAMS = {}


def _serve_model():
    """TinyLlama-1.1B at full width and depth, seeded random weights,
    bf16 activations: built once for the bf16 and int8 serve phases."""
    from apex_tpu_torch.models import GPTModel, TransformerConfig
    if not _SERVE_MODEL:
        cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16)
        _SERVE_MODEL.append(_new_model("serve", lambda: GPTModel(cfg)))
    return _SERVE_MODEL[0]


def _serve_config(**kw):
    from apex_tpu_torch.serving import ServeConfig
    return ServeConfig(batch_buckets=SERVE_BATCH_BUCKETS,
                       prefill_buckets=SERVE_PREFILL_BUCKETS,
                       num_slots=SERVE_SLOTS, **kw)


def _profile_decode(label, engine, vocab):
    """A profile of one engine decode call (or speculative round) over a
    full bucket of fresh slots."""
    prompts = [r.prompt for r in _serve_trace(vocab, n=SERVE_SLOTS, seed=2)]
    first = engine.prefill(list(range(SERVE_SLOTS)), prompts)
    profile_window(label, lambda: engine.decode(list(range(SERVE_SLOTS)),
                                                first), watch=PROFILE_WATCH)


def _profile_prefill(label, engine, vocab):
    """A profile of one engine prefill of a full bucket of slots (the
    same prompts each time: the slots are written anew)."""
    prompts = [r.prompt for r in _serve_trace(vocab, n=SERVE_SLOTS, seed=2)]
    profile_window(label, lambda: engine.prefill(list(range(SERVE_SLOTS)),
                                                 prompts),
                   watch=PROFILE_WATCH)


def phase_serve_bf16():
    from apex_tpu_torch.serving import ServeEngine
    model = _serve_model()
    L, vocab = model.num_layers, model.config.vocab_size
    engine = ServeEngine(model, _serve_config(cache_mode="bf16"))
    log(f"serve_bf16: kv_cache_bytes {engine.kv_cache_bytes()} "
        f"({engine.spec.cache_dtype_name()}, {SERVE_SLOTS} slots x "
        f"{engine.max_len} positions)")
    size = _ladder_report("serve_bf16", engine)
    streams, stats, launches = _serve_counted("serve_bf16", engine, vocab)
    assert engine.compile_count == size
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    _expect("serve_bf16", launches, {
        "rms_norm": (2 * L + 1) * (steps + calls),
        "gqa_decode": L * steps, "window_attention": L * calls})
    _per_step("serve_bf16", launches, stats, ("rms_norm", "gqa_decode"),
              {"rms_norm": 2 * L + 1})
    log(f"serve_bf16: window_attention {launches['window_attention'] / calls}"
        f" a prefill")
    with plain_versions():
        plain, _ = ServeEngine(model, _serve_config(cache_mode="bf16")
                               ).serve(_serve_trace(vocab))
    _margin_check("serve_bf16 kernels vs plain versions", model,
                  _serve_trace(vocab), streams, _streams(plain))
    _profile_decode("serve_bf16 decode step (bucket 8)", engine, vocab)
    _beside_eager("serve_bf16", model, _serve_config(cache_mode="bf16"),
                  vocab, (streams, stats, launches))
    _sampled_graphs_check()
    _SERVE_STREAMS["bf16"] = streams
    return {"serve_bf16": launches}


def _sampled_graphs_check():
    """An engine that samples (temperature 0.8, top-k 40) on its CUDA
    graphs, its generator's state registered with every graph: two
    engines from the same seed give the same streams, every token in the
    vocabulary; the same engine run eagerly is printed beside them. A
    2-layer model at TinyLlama's width keeps the ladders' capture short."""
    import dataclasses

    from apex_tpu_torch.models import GPTModel, TransformerConfig
    from apex_tpu_torch.serving import ServeEngine
    cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16)
    model = _new_model("sampled", lambda: GPTModel(
        dataclasses.replace(cfg, num_layers=2)))
    vocab = cfg.vocab_size
    config = _serve_config(cache_mode="bf16", temperature=0.8, top_k=40)
    runs = []
    for make in (ServeEngine, ServeEngine, _eager_engine):
        done, _ = make(model, config).serve(_serve_trace(vocab, n=6, seed=4))
        runs.append(_streams(done))
    assert runs[0] == runs[1], "two sampling engines from one seed differ"
    assert all(0 <= t < vocab for s in runs[0].values() for t in s)
    same = sum(runs[0][k] == runs[2][k] for k in runs[0])
    log(f"serve_bf16 sampling on CUDA graphs (temperature 0.8, top-k 40, "
        f"a 2-layer model): two engines from seed 0 gave identical streams; "
        f"{same} of {len(runs[0])} streams identical to the eager engine's "
        f"(not a check)")


def _int8_bound_check(model):
    """The same prompts prefilled into a bf16 and an int8 store: every
    dequantized K/V lane of the int8 store within half a grid step of its
    block's absmax (absmax / 254) of the bf16 store's value."""
    from apex_tpu_torch.kernels import quant
    from apex_tpu_torch.serving import ServeEngine
    vocab = model.config.vocab_size
    prompts = [r.prompt for r in _serve_trace(vocab, n=SERVE_SLOTS, seed=3)]
    engines = [ServeEngine(model, _serve_config(cache_mode=m))
               for m in ("bf16", "int8")]
    firsts = [e.prefill(list(range(SERVE_SLOTS)), prompts) for e in engines]
    assert (firsts[0] == firsts[1]).all()  # one prefill, two stores
    spec = engines[1].spec
    worst = 0.0
    for name in ("keys", "values"):
        for x, leaf in zip(engines[0]._store[name], engines[1]._store[name]):
            T, S = x.shape[:2]
            rows = x.reshape(T * S, spec.width).float()
            deq = quant.dequantize_rows(leaf["q"].reshape(T * S, 1, -1),
                                        leaf["scale"].reshape(T * S, 1, 1),
                                        spec.width)
            bound_ = rows.abs().amax(-1, keepdim=True) / 254.0
            err = (deq - rows).abs()
            # half a step, plus the fp32 roundings of the scale and of
            # q * s (a lane at a tie sits exactly half a step away)
            assert (err <= bound_ * (1 + 2 ** -20)
                    + rows.abs() * 2 ** -22).all(), name
            worst = max(worst, (err / bound_.clamp_min(1e-30)).max().item())
    log(f"serve_int8: int8 store vs bf16 store after one prefill of "
        f"{SERVE_SLOTS} prompts: every dequantized lane within absmax/254 "
        f"of its block (the largest error {worst:.4f} of the bound)")


def phase_serve_int8():
    from apex_tpu_torch.serving import KVCacheSpec, ServeEngine
    model = _serve_model()
    L, vocab = model.num_layers, model.config.vocab_size
    engine = ServeEngine(model, _serve_config(cache_mode="int8"))
    bf16_bytes = KVCacheSpec(model, SERVE_SLOTS, mode="bf16").total_bytes()
    int8_bytes = engine.kv_cache_bytes()
    fp32_bytes = engine.spec.total_bytes(kv_itemsize=4)
    log(f"serve_int8: kv_cache_bytes {int8_bytes} (int8 + fp32 scales) vs "
        f"{bf16_bytes} bf16: {bf16_bytes / int8_bytes:.3f}x smaller; "
        f"{fp32_bytes / int8_bytes:.3f}x against fp32 ({fp32_bytes})")
    assert int8_bytes < bf16_bytes
    size = _ladder_report("serve_int8", engine)
    streams, stats, launches = _serve_counted("serve_int8", engine, vocab)
    assert engine.compile_count == size
    steps, calls = stats["decode_steps"], stats["prefill_calls"]
    _expect("serve_int8", launches, {
        "rms_norm": (2 * L + 1) * (steps + calls),
        "gqa_decode": L * steps, "window_attention": L * calls,
        "quantize_int8": 2 * L * (steps + calls),
        "dequantize_int8": 2 * L * steps})
    _per_step("serve_int8", launches, stats,
              ("rms_norm", "gqa_decode", "quantize_int8", "dequantize_int8"),
              {"rms_norm": 2 * L + 1, "quantize_int8": 2 * L})
    log(f"serve_int8: quantize_int8 {2 * L} and window_attention {L} a "
        f"prefill")
    with plain_versions():
        plain, _ = ServeEngine(model, _serve_config(cache_mode="int8")
                               ).serve(_serve_trace(vocab))
    _margin_check("serve_int8 kernels vs plain versions", model,
                  _serve_trace(vocab), streams, _streams(plain))
    if "bf16" in _SERVE_STREAMS:
        agree = sum(streams[k] == v for k, v in _SERVE_STREAMS["bf16"].items())
        log(f"serve_int8: {agree} of {len(streams)} streams identical to the "
            f"bf16 cache's (not a check: int8 rounding moves the logits)")
    _int8_bound_check(model)
    _profile_prefill("serve_int8 prefill (bucket 8)", engine, vocab)
    _profile_decode("serve_int8 decode step (bucket 8)", engine, vocab)
    _beside_eager("serve_int8", model, _serve_config(cache_mode="int8"),
                  vocab, (streams, stats, launches))
    return {"serve_int8": launches}


def _spec_models():
    """bench.py ``_serve_spec_setup`` at TinyLlama width and depth: the
    target's layers past the first scaled by 0.25 (every parameter), and
    a 1-layer draft sharing its embedding, layer 0, final norm and
    head."""
    import dataclasses

    from apex_tpu_torch.models import GPTModel, TransformerConfig
    cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16)
    target = _new_model("serve_spec target", lambda: GPTModel(cfg))
    with torch.no_grad():
        for i, layer in enumerate(target.transformer.layers):
            if i:
                for p in layer.parameters():
                    p.mul_(0.25)
    draft = GPTModel(dataclasses.replace(cfg, num_layers=1))
    shared = {k: v for k, v in target.state_dict().items()
              if not k.startswith("transformer.layers.")
              or k.startswith("transformer.layers.0.")}
    draft.load_state_dict(shared)
    return target, draft


def phase_serve_spec():
    from apex_tpu_torch.serving import ServeEngine
    _SERVE_MODEL.clear()
    torch.cuda.empty_cache()
    target, draft = _spec_models()
    L, vocab = target.num_layers, target.config.vocab_size
    plain_engine = ServeEngine(target, _serve_config(cache_mode="bf16"))
    plain, plain_stats, _ = _serve_counted("serve_spec plain engine",
                                           plain_engine, vocab)
    engine = ServeEngine(target, _serve_config(
        cache_mode="bf16", draft_model=draft, num_draft_tokens=SPEC_K))
    log(f"serve_spec: target kv_cache_bytes {engine.kv_cache_bytes()}, "
        f"draft {engine.draft_kv_cache_bytes()}")
    size = _ladder_report("serve_spec", engine)
    streams, stats, launches = _serve_counted("serve_spec", engine, vocab)
    assert engine.compile_count == size
    rounds, calls = stats["decode_steps"], stats["prefill_calls"]
    feeds = SPEC_K + 1  # draft decode steps a round
    _expect("serve_spec", launches, {
        "rms_norm": (2 * L + 1 + 3 * feeds) * rounds + (2 * L + 1 + 3) * calls,
        "gqa_decode": feeds * rounds,
        "window_attention": L * rounds + (L + 1) * calls})
    log(f"serve_spec: window_attention {L} a round (the target's verify "
        f"window) and {L + 1} a prefill (target and draft); gqa_decode "
        f"{feeds} a round (the draft's steps); {stats['tokens_per_sec']:.1f}"
        f" tokens/s against the plain engine's "
        f"{plain_stats['tokens_per_sec']:.1f} on the same model")
    _margin_check("serve_spec vs the plain engine", target,
                  _serve_trace(vocab), streams, plain)
    with plain_versions():
        plain_spec, _ = ServeEngine(target, _serve_config(
            cache_mode="bf16", draft_model=draft,
            num_draft_tokens=SPEC_K)).serve(_serve_trace(vocab))
    _margin_check("serve_spec kernels vs plain versions", target,
                  _serve_trace(vocab), streams, _streams(plain_spec))
    _profile_decode("serve_spec round (bucket 8)", engine, vocab)
    _beside_eager("serve_spec", target, _serve_config(
        cache_mode="bf16", draft_model=draft, num_draft_tokens=SPEC_K),
        vocab, (streams, stats, launches))
    return {"serve_spec": launches}


# ------------------------------------------------------------ serve_prefix

def _prefix_trace(vocab, seed, n=SERVE_REQUESTS):
    from apex_tpu_torch.serving import synthetic_trace
    return synthetic_trace(n, seed=seed, mean_interarrival=0.1,
                           prompt_lens=PREFIX_TAILS, max_new=PREFIX_MAX_NEW,
                           vocab_size=vocab,
                           shared_prefix_len=PREFIX_SHARED, shared_frac=0.8)


def _prefix_config(**kw):
    from apex_tpu_torch.serving import ServeConfig
    return ServeConfig(batch_buckets=SERVE_BATCH_BUCKETS,
                       prefill_buckets=PREFIX_BUCKETS, num_slots=SERVE_SLOTS,
                       **kw)


def _prefix_kw(draft):
    return dict(draft_model=draft, num_draft_tokens=SPEC_K,
                prefix_cache=True, prefix_min_len=PREFIX_MIN_LEN,
                prefix_max_entries=PREFIX_ENTRIES)


def _copy_timer(engine):
    """CUDA events and host time around the prefix store's seed and
    insert copies of each prefill call (instance attributes shadow the
    methods). Returns the list the calls append to: (kind, bytes, host
    s, start event, end event)."""
    out = []

    def wrap(kind, fn):
        def run(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            nbytes = fn(*args, **kw)
            e1.record()
            out.append((kind, nbytes, time.perf_counter() - t0, e0, e1))
            return nbytes
        return run

    engine._seed_hits = wrap("seed", engine._seed_hits)
    engine._record_prefix = wrap("insert", engine._record_prefix)
    return out


def _copy_report(label, copies):
    torch.cuda.synchronize()
    for kind in ("seed", "insert"):
        rows = [(b, h, e0.elapsed_time(e1)) for k, b, h, e0, e1 in copies
                if k == kind]
        log(f"{label}: {kind} copies of each prefill call (bytes, host ms, "
            f"device ms between events): " + "; ".join(
                f"{b} {h * 1e3:.3f} {d:.3f}" for b, h, d in rows))


def _prefix_hits_by_call(engine):
    """Each prefill call's prefix cuts (instance attribute)."""
    out = []
    prefill = engine.prefill

    def run(slot_ids, prompts, **kw):
        t0 = time.perf_counter()
        first = prefill(slot_ids, prompts, **kw)
        out.append((list(engine.last_prefill_hits),
                    [tuple(int(t) for t in p) for p in prompts],
                    time.perf_counter() - t0))
        return first

    engine.prefill = run
    return out


def _seeded_rows_witness(engine, donor_rows):
    """After each prefill call of ``engine`` (instance attribute), every
    row seeded from a migration payload held against the donor's store
    rows it came from (``donor_rows``: {prompt tuple: this rank's rows,
    ``gather_rows``'s copy taken at extraction}) at the positions below
    its cut: the int8 codes and the scales of this rank's blocks, which
    the round trip through the payload's bf16 rows keeps bit for bit (a
    scale is a bf16 absmax over 127, and each code's dequantized value
    rounds back to it). Returns the totals the calls add to."""
    out = {"codes": 0, "codes_differ": 0, "code_max": 0, "scales": 0,
           "scales_differ": 0, "scale_rel_max": 0.0, "rows": 0}
    prefill = engine.prefill

    def run(slot_ids, prompts, **kw):
        first = prefill(slot_ids, prompts, **kw)
        for slot, p, cut in zip(slot_ids, prompts, engine.last_prefill_hits):
            want = donor_rows.get(tuple(int(t) for t in p))
            if not cut or want is None:
                continue
            got = engine.spec.gather_rows(engine._store, torch.tensor(
                [slot], dtype=torch.long, device=engine.device))
            out["rows"] += 1
            for name in ("keys", "values"):
                for g, w in zip(got[name], want[name]):
                    dq = (g["q"][:cut].int() - w["q"][:cut].int()).abs()
                    gs, ws = g["scale"][:cut].float(), w["scale"][:cut].float()
                    rel = (gs - ws).abs() / ws.abs().clamp_min(1e-30)
                    out["codes"] += dq.numel()
                    out["codes_differ"] += int((dq > 0).sum())
                    out["code_max"] = max(out["code_max"], int(dq.max()))
                    out["scales"] += ws.numel()
                    out["scales_differ"] += int((gs != ws).sum())
                    out["scale_rel_max"] = max(out["scale_rel_max"],
                                               float(rel.max()))
        return first

    engine.prefill = run
    return out


def phase_serve_prefix():
    from apex_tpu_torch.serving import ServeEngine
    _SERVE_MODEL.clear()
    torch.cuda.empty_cache()
    target, draft = _spec_models()
    L, vocab = target.num_layers, target.config.vocab_size
    warm, trace = _prefix_trace(vocab, 0), _prefix_trace(vocab, 1)
    plain_engine = ServeEngine(target, _prefix_config(cache_mode="bf16"))
    _ladder_report("serve_prefix plain engine", plain_engine)
    plain, plain_stats, _ = _serve_counted(
        "serve_prefix plain engine", plain_engine, vocab, trace, warm)
    del plain_engine
    config = _prefix_config(cache_mode="bf16", **_prefix_kw(draft))
    engine = ServeEngine(target, config)
    size = _ladder_report("serve_prefix", engine)
    before = engine.compile_count
    engine.serve(warm)
    assert engine.compile_count == before == size
    copies = _copy_timer(engine)
    streams, stats, launches = _serve_counted(
        "serve_prefix", engine, vocab, trace, _prefix_trace(vocab, 0, n=2))
    log(f"serve_prefix: compile_count {before} before the warm trace, "
        f"{engine.compile_count} after it and the measured trace (the "
        f"ladder: {size})")
    assert engine.compile_count == size
    rounds, calls = stats["decode_steps"], stats["prefill_calls"]
    feeds = SPEC_K + 1
    _expect("serve_prefix", launches, {
        "rms_norm": (2 * L + 1 + 3 * feeds) * rounds + (2 * L + 1 + 3) * calls,
        "gqa_decode": feeds * rounds,
        "window_attention": L * rounds + (L + 1) * calls})
    log(f"serve_prefix: {stats['tokens_per_sec']:.1f} tokens/s against the "
        f"plain engine's {plain_stats['tokens_per_sec']:.1f} on the same "
        f"trace ({stats['tokens_per_sec'] / plain_stats['tokens_per_sec']:.3f}"
        f"x); acceptance {stats['acceptance_rate']} of "
        f"{stats['spec_proposed']} proposals; prefix hits "
        f"{stats['prefix_hits']} of {stats['prefix_lookups']} lookups "
        f"(hit rate {stats['prefix_hit_rate']}, {stats['prefix_hit_tokens']} "
        f"tokens); TTFT p50 on a hit {stats['ttft_p50_prefix_hit_ms']} ms, "
        f"on a miss {stats['ttft_p50_prefix_miss_ms']} ms (the plain "
        f"engine's p50 {plain_stats['ttft_p50_ms']:.2f} ms); prefix store "
        f"{stats['prefix_store_entries']} entries, "
        f"{stats['prefix_store_bytes']} bytes")
    assert stats["prefix_hits"] > 0, stats
    _copy_report("serve_prefix", copies)
    _margin_check("serve_prefix vs the plain engine", target, trace,
                  streams, plain)
    with plain_versions():
        peng = ServeEngine(target, config)
        peng.serve(warm)
        plain_spec, _ = peng.serve(trace)
        del peng
    _margin_check("serve_prefix kernels vs plain versions", target, trace,
                  streams, _streams(plain_spec))
    _profile_decode("serve_prefix round (bucket 8)", engine, vocab)
    del engine
    torch.cuda.empty_cache()
    _migration_drill(target, vocab, trace)
    return {"serve_prefix": launches}


def _migration_drill(model, vocab, trace, build=None, label="serve_prefix"):
    """KV-state migration between two int8 prefix-cached engines: the
    donor's unfinished requests after MIGRATE_TICKS scheduler steps leave
    as checksummed payloads (``extract_kv_state``), a flipped byte fails
    the check, each continuation (prompt + emitted tokens) goes into the
    survivor's prefix store under its first ``length`` tokens (as the JAX
    fleet's ``_seed_prefix_from_payload`` does) and resumes with a
    one-token suffix; the completed streams are held to an unkilled run,
    and the handoff's time stands beside a token re-prefill of the same
    continuations. ``build(config)`` makes each engine (default a
    ``ServeEngine`` of ``model``)."""
    import numpy as np

    from apex_tpu_torch.serving import (
        PrefixStore,
        Request,
        Scheduler,
        ServeEngine,
        kv_payload_crc,
    )
    config = _prefix_config(cache_mode="int8", prefix_cache=True,
                            prefix_min_len=PREFIX_MIN_LEN,
                            prefix_max_entries=PREFIX_ENTRIES)

    def fresh_store():
        return PrefixStore(max_entries=PREFIX_ENTRIES,
                           min_len=PREFIX_MIN_LEN)

    build = build or (lambda c: ServeEngine(model, c))
    donor = build(config)
    donor.serve(_prefix_trace(vocab, 0, n=2))  # warm
    donor.adopt_prefix_store(fresh_store())
    want, _ = donor.serve(trace)                 # the unkilled run
    want = _streams(want)
    donor.adopt_prefix_store(fresh_store())
    sched = Scheduler(donor)
    for r in trace:
        sched.submit(r)
    for _ in range(MIGRATE_TICKS):
        sched.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = sched.extract_unfinished("migrated")
    slots = [r["slot"] for r in recs if r["slot"] is not None]
    payloads = donor.extract_kv_state(slots)
    extract_s = time.perf_counter() - t0
    assert donor.spec.mode == "int8", donor.spec.mode
    donor_rows = {}  # this rank's store rows of each slot, as extracted
    for r in recs:
        if r["slot"] is not None:
            donor_rows[tuple(int(t) for t in np.concatenate([
                r["request"].prompt, np.asarray(r["tokens"], np.int32)]))] \
                = donor.spec.gather_rows(donor._store, torch.tensor(
                    [r["slot"]], dtype=torch.long, device=donor.device))
    nbytes = sum(t.numel() * t.element_size() for p in payloads.values()
                 for name in ("keys", "values") for t in p["rows"][name])
    assert slots and all(kv_payload_crc(p) == p["crc"]
                         for p in payloads.values())
    bad = payloads[slots[0]]
    tampered = {**bad, "rows": {**bad["rows"],
                                "keys": list(bad["rows"]["keys"])}}
    leaf = tampered["rows"]["keys"][3].clone()
    leaf.view(-1).view(torch.uint8)[12345] ^= 1
    tampered["rows"]["keys"][3] = leaf
    assert kv_payload_crc(tampered) != bad["crc"]
    log(f"{label} migration: after {MIGRATE_TICKS} scheduler steps "
        f"{len(sched.completed)} requests done, {len(slots)} active and "
        f"{len(recs) - len(slots)} pending extracted; {len(slots)} payloads "
        f"({nbytes} bytes of raw K/V, int8 dequantized by #15) in "
        f"{extract_s * 1e3:.2f} ms; every crc verified, and one flipped "
        f"byte changed it")
    survivor = build(config)
    survivor.serve(_prefix_trace(vocab, 0, n=2))  # warm
    survivor.adopt_prefix_store(fresh_store())
    conts, carried = [], {}
    t0 = time.perf_counter()
    for r in recs:
        carry = np.concatenate([r["request"].prompt,
                                np.asarray(r["tokens"], np.int32)])
        if r["slot"] is not None:
            pay = payloads[r["slot"]]
            assert kv_payload_crc(pay) == pay["crc"]
            cut = min(pay["length"], len(carry) - 1)
            survivor.prefix_store.insert(carry[:cut], pay["rows"],
                                         pay["draft_rows"], scope="handoff")
            carried[r["request"].rid] = cut
        conts.append(Request(rid=r["request"].rid, prompt=carry,
                             max_new_tokens=r["request"].max_new_tokens
                             - len(r["tokens"])))
    insert_s = time.perf_counter() - t0
    calls = _prefix_hits_by_call(survivor)
    witness = _seeded_rows_witness(survivor, donor_rows)
    survivor_copies = _copy_timer(survivor)
    done, stats = survivor.serve(conts)
    w = witness
    log(f"{label} migration: the survivor's {w['rows']} seeded rows against "
        f"the donor's store rows they came from, this rank's "
        f"{survivor.spec.groups} groups in {survivor.spec.blocks} int8 "
        f"block(s) of {survivor.spec.block} lanes, below each cut: codes "
        f"{w['codes_differ']} of {w['codes']} differ (at most by "
        f"{w['code_max']}), scales {w['scales_differ']} of {w['scales']} "
        f"differ (at most {w['scale_rel_max']:.3e} relative), after the "
        f"payload's bf16 and the seeded prefill's quantize")
    assert w["rows"] == len(carried), (w["rows"], len(carried))
    assert w["codes_differ"] == 0 and w["scales_differ"] == 0, w
    got = {c.rid: c.tokens.tolist() for c in sched.completed}
    emitted = {r["request"].rid: list(r["tokens"]) for r in recs}
    got.update({c.rid: emitted[c.rid] + c.tokens.tolist() for c in done})
    assert len(got) == len(trace) and stats["requests_ok"] == len(conts)
    hit = {p: c for cuts, prompts, _ in calls for c, p in zip(cuts, prompts)}
    for c in conts:
        if c.rid in carried:
            assert hit[tuple(int(t) for t in c.prompt)] == carried[c.rid] \
                == len(c.prompt) - 1
    first_call = calls[0][2]
    # the same continuations re-prefilled from their tokens alone
    donor.adopt_prefix_store(fresh_store())
    active = [c for c in conts if c.rid in carried]
    donor_copies = _copy_timer(donor)
    t0 = time.perf_counter()
    donor.prefill(list(range(len(active))), [c.prompt for c in active],
                  pad_slot_ids=list(range(len(active), SERVE_SLOTS)))
    reprefill_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # each prefill call's own insert copies into pinned memory (new
    # prompts cached on the host) apart from its prefill
    inserts = [next(e0.elapsed_time(e1) for k, _, _, e0, e1 in copies
                    if k == "insert")
               for copies in (survivor_copies, donor_copies)]
    log(f"{label} migration: the survivor's first prefill call ("
        f"{len(calls[0][0])} continuations, {sum(1 for c in calls[0][0] if c)}"
        f" seeded with a one-token suffix) {first_call * 1e3:.2f} ms, "
        f"{inserts[0]:.2f} of it caching the new prompts' rows on the host; "
        f"the payloads' extraction {extract_s * 1e3:.2f} ms and insertion "
        f"{insert_s * 1e3:.2f} ms (crc checks included); against a token "
        f"re-prefill of the {len(active)} carried continuations "
        f"({max(len(c.prompt) for c in active)} tokens at most) "
        f"{reprefill_s * 1e3:.2f} ms, {inserts[1]:.2f} of it caching")
    _margin_check(f"{label} migration vs the unkilled run", model, trace,
                  got, want)
    del donor, survivor
    torch.cuda.empty_cache()


# ------------------------------------------------------- phases 9, 10

def _mla_model(label, cfg):
    """A DeepseekModel of ``cfg`` on the card with seeded random weights."""
    from apex_tpu_torch.models import DeepseekModel, init_weights
    t0 = time.perf_counter()
    model = DeepseekModel(cfg)
    init_weights(model, SEED)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"{label}: DeepseekModel {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_heads} heads, vocab {cfg.vocab_size}, "
        f"routed experts {cfg.n_routed_experts} (top {cfg.moe_top_k}), {n} "
        f"params in {cfg.params_dtype} "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated), "
        f"built in {time.perf_counter() - t0:.1f} s")
    return model


def _mla_norms(cfg):
    """RMSNorm launches of one forward: the input, post-attention and
    kv_a norms of each layer (and q_a_norm with a q latent), and the
    final norm."""
    return (3 + bool(cfg.q_lora_rank)) * cfg.num_layers + 1


def _greedy_steps(model, cache, tok, steps):
    """``steps`` single-token decode steps from tokens ``tok`` [b]:
    (tokens [b, steps], the fp32 logits [steps, b, vocab] each was chosen
    from, host ms of each synchronized step)."""
    from apex_tpu_torch.transformer import tensor_parallel
    out, scores, ms = [], [], []
    for _ in range(steps):
        t, (logits, cache) = _wall_ms(
            lambda: model.decode_step(tok[:, None], cache))
        # the full vocabulary of a tp = 2 rank's logits (tp = 1: as they are)
        scores.append(tensor_parallel.gather_from_tensor_model_parallel_region(
            logits[:, -1].float()))
        tok = torch.argmax(scores[-1], dim=-1)
        out.append(tok)
        ms.append(t)
    return torch.stack(out, dim=1), torch.stack(scores), ms


def _greedy(model, prompt, new):
    """Greedy decode of ``new`` tokens after ``prompt`` [b, s] through
    ``decode_prefill`` and ``decode_step``: (tokens [b, new], the fp32
    logits [new, b, vocab] each was chosen from)."""
    from apex_tpu_torch.transformer import tensor_parallel
    logits, cache = model.decode_prefill(prompt)
    first = tensor_parallel.gather_from_tensor_model_parallel_region(
        logits[:, -1].float())
    tok = torch.argmax(first, dim=-1)
    toks, scores, _ = _greedy_steps(model, cache, tok, new - 1)
    return (torch.cat([tok[:, None], toks], dim=1),
            torch.cat([first[None], scores]))


def _near_tie_check(label, got, got_logits, want, want_logits, tol):
    """Greedy streams ``got`` against ``want`` ([b, new] each), with the
    logits [new, b, vocab] each token was chosen from: where a row
    differs, both runs saw the same tokens before the first difference,
    and there each run's own logits must rank its token above the other
    run's by less than LOGIT_TOL, and the two runs' logits must agree
    within ``tol``, the phase's logits tolerance: a near tie that a
    last-place difference may break either way, not a wrong token. The
    other run's token need not be second: in a tie of three, logits
    that differ by far less than ``tol`` may order all three anew."""
    same = 0
    for r in range(got.shape[0]):
        a, b = got[r].tolist(), want[r].tolist()
        if a == b:
            same += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        mine = (got_logits[i, r, a[i]] - got_logits[i, r, b[i]]).item()
        theirs = (want_logits[i, r, b[i]] - want_logits[i, r, a[i]]).item()
        rank_mine = int((got_logits[i, r] > got_logits[i, r, b[i]]).sum())
        rank_theirs = int((want_logits[i, r] > want_logits[i, r, a[i]]).sum())
        err = max_abs(got_logits[i, r], want_logits[i, r])
        log(f"{label}: row {r} first differs at generated token {i} ({a[i]} "
            f"vs {b[i]}); margins there {mine:.4f} (kernels) and "
            f"{theirs:.4f} (plain versions), tolerance {LOGIT_TOL}; the "
            f"other run's token ranks {rank_mine + 1} and {rank_theirs + 1}; "
            f"logits there within {err:.4f} (tolerance {tol})")
        assert 0 <= mine < LOGIT_TOL and 0 <= theirs < LOGIT_TOL, (
            label, r, i, mine, theirs)
        assert err <= tol, (label, r, i, err)
    log(f"{label}: {same} of {got.shape[0]} streams identical")


def _hold_logits(label, got, want, tol=LOGIT_TOL):
    assert torch.isfinite(got).all(), label
    top2 = torch.topk(want, 2, dim=-1).values
    beyond = ((got - want).abs() > LOGIT_TOL).float().mean().item()
    log(f"{label} logits kernels vs plain: max abs err "
        f"{max_abs(got, want):.3e} (tolerance {tol}), relative Frobenius "
        f"{_rel_fro(got, want):.3e}, share beyond {LOGIT_TOL} {beyond:.3e}, "
        f"logit std {want.std().item():.3f}, smallest top-2 gap "
        f"{(top2[..., 0] - top2[..., 1]).min().item():.3e}")
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@contextlib.contextmanager
def _einsum_decode():
    """The model's single-token steps on its einsum branch (as bench.py
    runs them with APEX_TPU_MLA_FLASH=0): the branch test answers no."""
    from apex_tpu_torch.contrib import mla_decode
    real = mla_decode.use_flash
    mla_decode.use_flash = lambda *args, **kw: False
    try:
        yield
    finally:
        mla_decode.use_flash = real


@contextlib.contextmanager
def _recorded_routing(into):
    """Append each MoE layer's routing (token and expert of every
    assignment) to ``into`` while it runs."""
    from apex_tpu_torch.transformer.moe import router
    real = router.compute_routing_sorted

    def record(*args, **kw):
        routing = real(*args, **kw)
        into.append((routing.token_idx, routing.expert_idx))
        return routing

    router.compute_routing_sorted = record
    try:
        yield
    finally:
        router.compute_routing_sorted = real


def _restored(cache, rows, pos):
    """``cache`` with its buffers set to ``rows`` and its level to ``pos``:
    a step then reads the prefix that the step it repeats read."""
    for buf, t in zip(cache.latent, rows):
        buf.copy_(t)
    cache.pos = pos
    return cache


def _mla_kernel_fault(code):
    """A planted #26 fault of MLA_KERNEL_FAULTS in place of the wrapper:
    the same call, launched on fault path ``code``."""
    def fault(real):
        def run(q, cache, length, lat, scale):
            from apex_tpu_torch.kernels import _checks
            lengths = _checks.row_offsets("mla_flash_decode", length,
                                          q.shape[0], q.device, "length")
            return _mla_raw(q, cache, lengths, lat, scale, code)
        return run
    return fault


def _short_mean_square(real):
    def run(x, w, eps, out_dtype=None):
        h = x.shape[-1]
        sq = x.float().square()
        full = sq.mean(-1, keepdim=True) + eps
        part = sq[:, :h - h // 8].sum(-1, keepdim=True) / h + eps
        return (real(x, w, eps, torch.float32)
                * (full / part).sqrt()).to(out_dtype or x.dtype)
    return run


def _toward_zero(real):
    def run(x, w, eps, out_dtype=None):
        y = real(x, w, eps, torch.float32)
        if (out_dtype or x.dtype) == torch.bfloat16:
            y = (y.view(torch.int32) & -65536).view(torch.float32)
        return y.to(out_dtype or x.dtype)
    return run


# deliberate faults in the kernels of the MLA paths, each in place of the
# real wrapper (name, wrapper, fault, planted in the prefill too, the
# logits checks must see it): #26, through its own launch (fault paths of
# the tensor-core body), drops its last live split in the merge (the
# current token's own row among those lost; unsplit, its last stage) or
# leaves the rope columns out of its scores; RMSNorm's mean square misses
# the row's last eighth, or its bf16 output rounds toward zero. That last
# fault moves half the outputs by less than an ulp, less than the logits'
# honest error: check_rms_norm's share of outputs that differ holds it.
MLA_FAULTS = (("mla_decode drops its last live split", "mla_flash_decode",
               _mla_kernel_fault(2), False, True),
              ("mla_decode leaves the rope columns out of its scores",
               "mla_flash_decode", _mla_kernel_fault(3), False, True),
              ("rms_norm misses an eighth of the row", "rms_fwd",
               _short_mean_square, True, True),
              ("rms_norm rounds toward zero", "rms_fwd", _toward_zero, True,
               False))


@contextlib.contextmanager
def _planted(attr, fault):
    from apex_tpu_torch.contrib import mla_decode
    from apex_tpu_torch.kernels import norm
    mod = mla_decode if attr == "mla_flash_decode" else norm
    real = getattr(mod, attr)
    setattr(mod, attr, fault(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def _fault_check(label, readings, prefill_tol):
    """Every planted fault that the logits checks must see reads beyond
    the tolerance that the honest kernels are held to there: the
    prefill's ``prefill_tol``, step 1's LOGIT_TOL."""
    tol = {"prefill": prefill_tol, "step 1": LOGIT_TOL}
    seen = {f[0] for f in MLA_FAULTS if f[4]}
    unseen = {k: v for k, v in readings.items()
              if k[0] in seen and not v > tol[k[1]]}
    assert not unseen, (label, tol, unseen)


def _fault_readings(label, prefill, want0, step, want1):
    """Each MLA_FAULTS fault planted in turn: the logits of ``prefill()``
    (RMSNorm's faults) and of ``step()`` against the plain versions'
    ``want0`` and ``want1``, as _hold_logits reads them. Returns
    {(fault, "prefill" or "step 1"): max abs err}."""
    out = {}
    for name, attr, fault, in_prefill, _ in MLA_FAULTS:
        runs = ((("prefill", prefill, want0),) if in_prefill else ()) + (
            ("step 1", step, want1),)
        for where, fn, want in runs:
            with _planted(attr, fault):
                got = fn()
            err = max_abs(got, want)
            out[name, where] = err
            log(f"{label} {where} with a planted fault ({name}): logits max "
                f"abs err {err:.3e}, relative Frobenius "
                f"{_rel_fro(got, want):.3e}")
            del got
    return out


def _choices(routing, tokens, experts):
    """[tokens, experts] True where a token chose an expert."""
    chosen = torch.zeros(tokens, experts, dtype=torch.bool,
                         device=routing[0].device)
    chosen[routing[0], routing[1]] = True
    return chosen


def phase_mla_decode():
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import MLAConfig
    cfg = MLAConfig(**MLA_DECODE_CFG, params_dtype=torch.float32,
                    compute_dtype=torch.bfloat16)
    model = _mla_model("mla_decode", cfg)
    b, P, steps, L = MLA_BATCH, MLA_PREFIX, MLA_STEPS, cfg.num_layers
    prompt = torch.randint(0, cfg.vocab_size, (b, P), generator=torch.Generator(
        ).manual_seed(SEED)).cuda()
    norms = _mla_norms(cfg)

    # the main path, counted: a prefill, one warm step, the timed steps
    registry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms, (k0, cache) = _wall_ms(lambda: model.decode_prefill(prompt))
    _expect("mla_decode prefill", registry.launches(), {"rms_norm": norms})
    tok0 = torch.argmax(k0[:, -1], dim=-1)
    saved = [t.clone() for t in cache.latent]
    warm_ms, (k1, cache) = _wall_ms(
        lambda: model.decode_step(tok0[:, None], cache))
    tok1 = torch.argmax(k1[:, -1], dim=-1)
    toks, scores, step_ms = _greedy_steps(model, cache, tok1, steps)
    launches = registry.launches()
    _expect("mla_decode", launches, {"rms_norm": norms * (2 + steps),
                                     "mla_decode": L * (1 + steps)})
    log(f"mla_decode: launches a decode step: rms_norm {norms}, mla_decode "
        f"{L}; a prefill: rms_norm {norms}, mla_decode 0; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    stream = torch.cat([tok0[:, None], tok1[:, None], toks], dim=1)
    stream_logits = torch.cat([k0[None, :, -1].float(),
                               k1[None, :, -1].float(), scores])
    del scores
    assert stream.shape == (b, steps + 2)
    assert 0 <= int(stream.min()) and int(stream.max()) < cfg.vocab_size
    again_ms, _ = _wall_ms(lambda: model.decode_prefill(prompt))
    kernel_s = sum(step_ms) / 1e3
    log(f"mla_decode: prefill ({b}x{P} tokens) {prefill_ms:.2f} ms (first, "
        f"counted), {again_ms:.2f} ms (again); warm step {warm_ms:.2f} ms; "
        f"decode step {_spread(step_ms)}; {b * steps / kernel_s:.1f} tokens/s "
        f"over the {steps} timed steps (host clock, synchronized)")
    profile_window("mla_decode decode step (kernel)",
                   lambda: model.decode_step(stream[:, -1:], cache),
                   watch=("mla_",))

    # yardstick: the same steps on the model's einsum branch
    _restored(cache, saved, P)
    with _einsum_decode():
        registry.reset()
        _, (e1, cache) = _wall_ms(
            lambda: model.decode_step(tok0[:, None], cache))
        etoks, _, e_ms = _greedy_steps(model, cache,
                                       torch.argmax(e1[:, -1], dim=-1), steps)
        assert registry.launches()["mla_decode"] == 0
        profile_window("mla_decode decode step (einsum branch)",
                       lambda: model.decode_step(etoks[:, -1:], cache))
    einsum_s = sum(e_ms) / 1e3
    agree = (etoks == toks).float().mean().item()
    log(f"mla_decode: einsum branch decode step {_spread(e_ms)}; "
        f"{b * steps / einsum_s:.1f} tokens/s against the kernel's "
        f"{b * steps / kernel_s:.1f} ({einsum_s / kernel_s:.3f}x); timed "
        f"tokens equal to the kernel run's: {agree:.4f} (not a check)")

    # the same model through the plain versions: the prefill, the first
    # step on the kernels' prefix and first token, and a greedy stream of
    # its own
    def step1():
        return model.decode_step(tok0[:, None], _restored(cache, saved, P))[0]

    with plain_versions():
        registry.reset()
        p0, pcache = model.decode_prefill(prompt)
        del pcache
        _hold_logits("mla_decode prefill", k0, p0)
        del k0
        p1 = step1()
        _hold_logits("mla_decode step 1", k1, p1)
        plain, plain_logits = _greedy(model, prompt, steps + 2)
        assert not any(registry.launches().values()), registry.launches()
    _near_tie_check("mla_decode kernels vs plain versions", stream,
                    stream_logits, plain, plain_logits, LOGIT_TOL)
    _fault_check("mla_decode", _fault_readings(
        "mla_decode", lambda: model.decode_prefill(prompt)[0], p0, step1, p1),
        LOGIT_TOL)
    return {"mla_decode": launches}


def phase_deepseek_v2_lite():
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import MLAConfig, mla_cached_generate
    cfg = MLAConfig(**V2_LITE_CFG, params_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16)
    model = _mla_model("deepseek_v2_lite", cfg)
    b, P, new, L = V2_BATCH, V2_PROMPT, V2_NEW, cfg.num_layers
    prompt = torch.randint(0, cfg.vocab_size, (b, P), generator=torch.Generator(
        ).manual_seed(SEED)).cuda()
    norms = _mla_norms(cfg)
    moe_layers = L - cfg.first_k_dense_replace

    # the main path, counted
    registry.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen_ms, tokens = _wall_ms(lambda: mla_cached_generate(model, prompt, new))
    launches = registry.launches()
    _expect("deepseek_v2_lite", launches, {"rms_norm": norms * new,
                                           "mla_decode": L * (new - 1)})
    log(f"deepseek_v2_lite: mla_cached_generate({b}x{P} prompt, {new} new "
        f"tokens, greedy) in {gen_ms:.1f} ms; launches a decode step: "
        f"rms_norm {norms}, mla_decode {L}; a prefill: rms_norm {norms}, "
        f"mla_decode 0; host syncs a forward: {moe_layers} (one a MoE "
        f"layer, its expert group sizes); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert tokens.shape == (b, P + new)
    assert torch.equal(tokens[:, :P], prompt)
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size

    # timed: the prefill (its routing recorded) and the steps
    kernel_routes = []
    with _recorded_routing(kernel_routes):
        prefill_ms, (k0, cache) = _wall_ms(
            lambda: model.decode_prefill(prompt))
    saved = [t.clone() for t in cache.latent]
    # the logits each generated token is chosen from, replayed on the
    # stream's own tokens
    step_ms, scores = [], [k0[:, -1].float()]
    for i in range(new - 1):
        t, (logits, cache) = _wall_ms(
            lambda: model.decode_step(tokens[:, P + i:P + i + 1], cache))
        step_ms.append(t)
        scores.append(logits[:, -1].float())
        if i == 0:
            k1 = logits
    scores = torch.stack(scores)
    replayed = (scores.argmax(-1).t() == tokens[:, P:]).float().mean().item()
    log(f"deepseek_v2_lite: prefill ({b}x{P} tokens) {prefill_ms:.2f} ms; "
        f"decode step {_spread(step_ms)}; "
        f"{b * (new - 1) / (sum(step_ms) / 1e3):.1f} tokens/s over the "
        f"{new - 1} steps at batch {b} (host clock, synchronized); the "
        f"replay's greedy tokens equal mla_cached_generate's: {replayed:.4f}")
    assert replayed == 1.0, "the kernels' decode is not deterministic"
    profile_window("deepseek_v2_lite decode step",
                   lambda: model.decode_step(tokens[:, -1:], cache),
                   watch=("mla_", "rms_"))

    # the same model through the plain versions: the prefill, the first
    # step on the kernels' prefix and first token, and a greedy stream of
    # its own
    def step1():
        return model.decode_step(tokens[:, P:P + 1],
                                 _restored(cache, saved, P))[0]

    plain_routes = []
    with plain_versions():
        registry.reset()
        with _recorded_routing(plain_routes):
            p0, pcache = model.decode_prefill(prompt)
        del pcache
        _hold_logits("deepseek_v2_lite prefill", k0, p0, MOE_LOGIT_TOL)
        del k0
        p1 = step1()
        _hold_logits("deepseek_v2_lite step 1", k1, p1)
        plain, plain_logits = _greedy(model, prompt, new)
        assert not any(registry.launches().values()), registry.launches()
    assert len(kernel_routes) == len(plain_routes) == moe_layers
    E, k, T = cfg.n_routed_experts, cfg.moe_top_k, b * P
    agree = sum((_choices(a, T, E) & _choices(p, T, E)).sum().item()
                for a, p in zip(kernel_routes, plain_routes))
    log(f"deepseek_v2_lite: prefill top-{k} expert choices equal between the "
        f"kernel and plain runs: {agree / (moe_layers * T * k):.6f} of "
        f"{moe_layers * T * k}")
    _near_tie_check("deepseek_v2_lite kernels vs plain versions",
                    tokens[:, P:], scores, plain, plain_logits, MOE_LOGIT_TOL)
    _fault_check("deepseek_v2_lite", _fault_readings(
        "deepseek_v2_lite", lambda: model.decode_prefill(prompt)[0], p0,
        step1, p1), MOE_LOGIT_TOL)
    return {"deepseek_v2_lite": launches}


# ------------------------------------------------- data parallelism

# DistributedDataParallel's modes and default bucket cap
DDP_MODES = (None, "bf16", "int8", "int4")
DDP_MESSAGE_SIZE = 10000000
# bench.py bench_ddp_compressed (bench.py:1628-1706): a 4 x 1024 tanh MLP
# regressor, RandomState(0) weights and data, batch 64, w - 0.05 g
MLP_DEPTH, MLP_HIDDEN, MLP_BATCH, MLP_LR, MLP_STEPS = 4, 1024, 64, 0.05, 30


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group for the length of a phase, as
    ``multiproc.initialize_distributed()`` makes it with no coordinator."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc
    t0 = time.perf_counter()
    backend = multiproc.initialize_distributed()
    log(f"process group: {backend}, world size {dist.get_world_size()}, "
        f"rank {dist.get_rank()}, up in {time.perf_counter() - t0:.2f} s")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _quant_counts(mode, buckets):
    """The quantize and dequantize launches of one sync of ``buckets``
    buckets in ``mode``: the int modes quantize each bucket once and
    dequantize its int32 sum once (#15, in int4 too)."""
    if mode == "int8":
        return {"quantize_int8": buckets, "dequantize_int8": buckets}
    if mode == "int4":
        return {"quantize_int4": buckets, "dequantize_int8": buckets}
    return {}


def _ulps(got, want):
    """Largest |got - want| in units of want's fp32 ulp."""
    mag = want.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return ((got - want).abs() / ulp).max().item()


def _hold_sync(label, ddp, grads, residual):
    """A step's local gradients and incoming residual synced once through
    the kernels and once under plain_versions(): the synced gradients and
    the new residual bit-identical; at world 1, synced + new residual
    equal to g + old residual (the payload quantized) within one fp32 ulp
    of each element."""
    from apex_tpu_torch.kernels import registry
    out, res = ddp.sync(grads, residual)
    registry.reset()
    with plain_versions():
        out_p, res_p = ddp.sync(grads, residual)
    assert not any(registry.launches().values()), registry.launches()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, out_p)), label
    assert all(torch.equal(a, b) for a, b in zip(res, res_p)), label
    worst = max(_ulps(o + r, g.float() + r0)
                for g, r0, o, r in zip(grads, residual, out, res))
    log(f"{label}: the sync of step {COUNTED_STEPS}'s gradients and "
        f"residual is bit-identical to its plain route (gradients and new "
        f"residual); synced + new residual vs g + old residual: largest "
        f"difference {worst:.3f} fp32 ulp (limit 1)")
    assert worst <= 1.0, (label, worst)


def _zero_collectives(label, flat_g, flat_p):
    """The ZeRO collectives on GPT-2's flat fp32 gradient and parameter
    vectors, each called once with the counts set to 0 around it and
    held bit-identical to its plain route. Returns their launches."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.parallel import compression
    totals = {}

    def run(name, fn, expect):
        registry.reset()
        ms, out = _wall_ms(fn)
        launches = {k: v for k, v in registry.launches().items() if v}
        assert launches == expect, (name, launches, expect)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        with plain_versions():
            want = fn()
        assert not any(registry.launches()[k] - launches.get(k, 0)
                       for k in registry.launches()), registry.launches()
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(outs, wants)), name
        log(f"{label}: {name} of {flat_g.numel()} fp32: launches {launches} "
            f"(expected), bit-identical to its plain route, {ms:.2f} ms "
            f"(host clock, synchronized)")
        return out

    for mode in ("int8", "int4"):
        run(f"psum_scatter_compressed {mode}",
            lambda: compression.psum_scatter_compressed(flat_g, "dp",
                                                        mode=mode),
            _quant_counts(mode, 1))
    gathers = {"bf16": {}, "int8": {"quantize_int8": 1, "dequantize_int8": 1},
               "int4": {"quantize_pack_int4": 1, "unpack_dequantize_int4": 1}}
    for mode, expect in gathers.items():
        y = run(f"all_gather_compressed {mode}",
                lambda: compression.all_gather_compressed(flat_p, "dp",
                                                          mode=mode),
                expect)
    x2d = flat_p.reshape(-1, 256)
    s, gmax = _int4_scales(x2d, with_gmax=True)
    ratio, clipped = _int4_error(x2d, y.reshape(-1, 256), s, gmax)
    log(f"{label}: int4 gather error: largest {ratio:.4f} of the local "
        f"effective scale (limit 0.5) where the code is not clipped; "
        f"{clipped:.3e} of the lanes clipped at +-7, each within half a "
        f"level-1 step (gmax / 510)")
    return totals


def phase_ddp_gpt2():
    """GPT-2 345M as phase_gpt2_training runs it, with
    DistributedDataParallel(axis_name="dp", compress=mode).sync between
    backward and opt.step() on a one-rank NCCL group: bucketed at 10 M
    elements, the residual carried from step to step, the synced
    gradients back in p.grad; every mode counted, timed and profiled; the
    last counted step's sync held to its plain route; then the ZeRO
    collectives on the model's flat gradient and parameter vectors."""
    import math

    import numpy as np

    from apex_tpu_torch.kernels import optim
    from apex_tpu_torch.models import (
        GPTModel,
        TransformerConfig,
        gpt_loss_fn,
        init_weights,
    )
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (
        DistributedDataParallel,
        compression,
        plan_buckets,
    )
    cfg = TransformerConfig(**GPT2, compute_dtype=torch.bfloat16,
                            use_flash_attention=True)
    launches, results = {}, {}
    with one_rank_group():
        model = _new_model("ddp gpt2", lambda: GPTModel(cfg))
        params = list(model.parameters())
        n = sum(p.numel() for p in params)
        buckets = plan_buckets(params, DDP_MESSAGE_SIZE)
        B = len(buckets)
        log(f"ddp gpt2: {len(params)} {params[0].dtype} tensors, {n} "
            f"elements, {compression.num_blocks(n)} blocks of 256; B = {B} "
            f"buckets of at most {DDP_MESSAGE_SIZE} elements in registration "
            f"order (largest {max(sum(params[i].numel() for i in b) for b in buckets)})")
        rng = np.random.RandomState(SEED)  # bench_gpt2's batch
        shape = (GPT2_BATCH, GPT2_SEQ)
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
        labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
        L = cfg.num_layers
        base = {"layer_norm": 2 * L + 1, "ln_bwd": 2 * L + 1,
                "flash_fwd": L, "flash_dq": L, "flash_dkv": L,
                "adam": math.ceil(len(params) / optim.MAX_TENSORS)}
        held = None
        for mode in DDP_MODES:
            name = mode or "fp32"
            init_weights(model, SEED)
            ddp = DistributedDataParallel(axis_name="dp", compress=mode)
            stateful = compression.needs_residual(mode)
            state = dict(res=None, events=[], held=None)

            def sync(k, ddp=ddp, state=state, stateful=stateful):
                grads = [p.grad for p in params]
                if k == COUNTED_STEPS - 1 and stateful:  # kept on the host,
                    # out of the peak memory of the timed steps
                    state["held"] = ([g.cpu() for g in grads],
                                     [r.cpu() for r in state["res"]])
                ev = None
                if k is None:  # a timed or profiled step
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                if stateful:
                    synced, state["res"] = ddp.sync(grads, state["res"])
                else:
                    synced = ddp.sync(grads)
                if ev:
                    ev[1].record()
                    state["events"].append(ev)
                for p, g in zip(params, synced):
                    p.grad = g

            rec = {}
            launches[f"ddp_gpt2_{name}"] = train_steps(
                f"ddp gpt2 {name}", model,
                lambda: gpt_loss_fn(model(tokens), labels),
                lambda ps: FusedAdam(ps, lr=GPT2_LR),
                {**base, **_quant_counts(mode, B)},
                (GPT2_BATCH * GPT2_SEQ, "tokens"), sync=sync,
                hold_plain=False, record=rec,
                watch=PROFILE_WATCH + ("nccl", "Memcpy", "::quant4_kernel<",
                                       "::quant_kernel<", "::dequant_kernel<",
                                       "direct_copy_kernel"),
                ranges=("ddp/sync",))
            torch.cuda.synchronize()
            rec["sync_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in state["events"][:TIMED_STEPS])
            results[name] = rec
            if stateful:
                grads, residual = ([t.cuda() for t in ts]
                                   for ts in state["held"])
                _hold_sync(f"ddp gpt2 {name}", ddp, grads, residual)
                if mode == "int4":
                    held = grads
                del grads, residual
            del state
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()

        fp32 = results["fp32"]
        for name, rec in results.items():
            prof = rec["profile"] or {}
            sync_us = (prof.get("ranges") or {}).get("ddp/sync")
            nccl = (prof.get("watch") or {}).get("nccl")
            mode = None if name == "fp32" else name
            log(f"ddp gpt2 {name}: step {rec['timed_ms']:.2f} ms = "
                f"{GPT2_BATCH * GPT2_SEQ / rec['timed_ms'] * 1e3:.1f} "
                f"tokens/s; sync {rec['sync_ms']:.3f} ms by CUDA events "
                f"({rec['sync_ms'] / rec['timed_ms']:.4f} of the step); "
                f"the sync's kernels under the profiler "
                + ("not measured" if sync_us is None else
                   f"{sync_us / 1e3:.3f} ms on the device "
                   f"({sync_us / prof['busy_us']:.4f} of the busy time)")
                + "; NCCL kernels "
                + ("not measured" if nccl is None else
                   f"{nccl / prof['busy_us']:.4f} of the busy time")
                + f"; peak {rec['peak_gib']:.2f} GiB; loss at step "
                f"{COUNTED_STEPS} {rec['losses'][-1]:.6f} (fp32 "
                f"{fp32['losses'][-1]:.6f}); modeled wire bytes a step at "
                f"world 8 (ring model, not a measurement) "
                f"{compression.estimate_allreduce_bytes(n, world=8, compress=mode)}"
                f" vs fp32 {compression.estimate_allreduce_bytes(n, world=8)}")

        flat_g = torch.cat([g.reshape(-1) for g in held])
        del held
        with torch.no_grad():
            flat_p = torch.cat([p.reshape(-1) for p in params])
        del model, params
        torch.cuda.empty_cache()
        launches["ddp_gpt2_zero"] = _zero_collectives("ddp gpt2", flat_g,
                                                      flat_p)
    return launches


def phase_ddp_compressed():
    """bench.py bench_ddp_compressed as it stands, on a one-rank NCCL
    group: the 4 x 1024 tanh MLP, batch 64, RandomState(0) weights and
    data, grads synced by DistributedDataParallel(compress=mode) with
    error feedback, w - 0.05 g; in "int8" (bench's mode) and "int4"."""
    import numpy as np

    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.parallel import DistributedDataParallel, plan_buckets
    H = MLP_HIDDEN
    rng = np.random.RandomState(0)
    init = {}
    for i in range(MLP_DEPTH):
        init[f"w{i}"] = (rng.randn(H, H).astype(np.float32)
                         / np.sqrt(H)).astype(np.float32)
        init[f"b{i}"] = np.zeros(H, np.float32)
    x = torch.from_numpy(rng.randn(MLP_BATCH, H).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randn(MLP_BATCH, H).astype(np.float32)).cuda()
    launches = {}
    with one_rank_group():
        for mode in ("int8", "int4"):
            params = {k: torch.from_numpy(v).cuda().requires_grad_()
                      for k, v in init.items()}
            ddp = DistributedDataParallel(axis_name="dp", compress=mode)
            B = len(plan_buckets(list(params.values())))
            state = {"res": None}

            def step(params=params, ddp=ddp, state=state):
                h = x
                for i in range(MLP_DEPTH):
                    h = torch.tanh(h @ params[f"w{i}"] + params[f"b{i}"])
                loss = torch.mean((h - y) ** 2)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                grads, state["res"] = ddp.sync(grads, state["res"])
                with torch.no_grad():
                    for k, p in params.items():
                        p -= MLP_LR * grads[k]
                return loss

            expected = {**dict.fromkeys(registry.launches(), 0),
                        **_quant_counts(mode, B)}
            losses, totals = [], dict.fromkeys(expected, 0)
            for _ in range(COUNTED_STEPS):
                registry.reset()
                losses.append(step().item())
                got = registry.launches()
                assert got == expected, (mode, got, expected)
                for k in totals:
                    totals[k] += got[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MLP_STEPS):
                loss = step()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            losses.append(loss.item())
            n = sum(p.numel() for p in params.values())
            log(f"ddp_compressed {mode}: {n} parameters in B = {B} bucket; "
                f"launches per step { {k: v for k, v in expected.items() if v} }"
                f" (every counted step); {MLP_STEPS} steps in {secs:.3f} s = "
                f"{MLP_STEPS / secs:.2f} steps/s (host clock, synchronized); "
                f"loss {losses[0]:.9f} at step 1, {losses[-1]:.9f} after "
                f"{COUNTED_STEPS + MLP_STEPS} steps")
            assert losses[-1] < losses[0], (mode, losses)
            launches[f"ddp_compressed_{mode}"] = totals
    return launches


# ------------------------------------------------------------------ ZeRO

# the sharded LAMB against the unsharded FusedLAMB at step 1 from the same
# gradients: each new parameter within one fp32 ulp plus this share of its
# update (tests/test_torch_zero.py fixes it against JAX's pair: the same
# elementwise math, the gradient norm and each tensor's ||p|| and
# ||update|| summed in another order)
ZERO_VS_FUSED_LAMB_RTOL = 1e-5


class _ZeroOpt:
    """A ZeRO optimizer behind the calls train_steps makes of a
    torch.optim optimizer: ``step()`` hands each ``p.grad`` to
    ``opt.step`` and copies the new params into the model's."""

    def __init__(self, opt, params):
        self.opt, self.params = opt, list(params)
        self.state = opt.init([p.detach() for p in self.params])
        self.param_groups = [{"step": 0}]

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        new, self.state = self.opt.step(grads, self.state, self.params)
        torch._foreach_copy_(self.params, new)
        self.param_groups[0]["step"] = int(self.state["step"])

    def zero_grad(self):
        for p in self.params:
            p.grad = None


def _step1_grads(model, loss_of):
    """The model's gradients at its current weights (one backward)."""
    loss = loss_of()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return [g.detach() for g in grads]


def _ulps_apart(got, want):
    """The largest |got - want| over the tensors in units of want's fp32
    ulp, and the share of entries that differ."""
    worst, differ, n = 0.0, 0, 0
    for g, w in zip(got, want):
        worst = max(worst, _ulps(g.float(), w.float()))
        differ += (g != w).sum().item()
        n += w.numel()
    return worst, differ / n


def _lamb_excess(got, want, before):
    """max over entries of (|got - want| - one fp32 ulp of want) / |want -
    before| (tests/test_torch_zero.py ``excess_over_ulp``)."""
    worst = 0.0
    for g, w, b in zip(got, want, before):
        w64 = w.double()
        ulp = (torch.nextafter(w.abs(), torch.full_like(w, float("inf")))
               - w.abs()).double()
        upd = (w64 - b.double()).abs().clamp_min(1e-30)
        ex = ((g.double() - w64).abs() - ulp).clamp_min(0) / upd
        worst = max(worst, ex.max().item())
    return worst


def _zero_round_trip(label, opt, state, params):
    """state_dict_full -> load_state_dict_resharded at world 1, every
    tensor bit-exact."""
    t0 = time.perf_counter()
    full = opt.state_dict_full(state, params, world=1)
    back = opt.load_state_dict_resharded(full, params, world=1,
                                         device="cuda")
    secs = time.perf_counter() - t0
    keys = sorted(k for k in state if k != "step")
    assert sorted(k for k in back if k != "step") == keys, (keys, back)
    for k in keys:
        got = back[k][0] if k == "grad_residual" else back[k]  # rank 0's row
        assert torch.equal(got, state[k]), (label, k)
    assert int(back["step"]) == int(state["step"])
    log(f"{label}: state_dict_full -> load_state_dict_resharded at world 1: "
        f"{keys} and step {int(state['step'])} bit-exact, {full['n_elements']}"
        f" elements, {secs:.1f} s on the host")


def _zero_gpt2_monolithic(model, loss_of, per_step):
    """DistributedFusedAdam(lr=GPT2_LR, compress=True) through train_steps,
    then step 1 against FusedAdam's from the same gradients, the state's
    bytes and the elastic round trip."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models import init_weights
    from apex_tpu_torch.optimizers import FusedAdam
    params = list(model.parameters())
    holder = {}

    def make_opt(ps):
        holder["z"] = _ZeroOpt(DistributedFusedAdam(lr=GPT2_LR, compress=True),
                               ps)
        return holder["z"]

    launches = train_steps(
        "zero gpt2", model, loss_of, make_opt, per_step,
        (GPT2_BATCH * GPT2_SEQ, "tokens"), record=(rec := {}),
        watch=PROFILE_WATCH + ("direct_copy_kernel", "CatArrayBatched"))
    z = holder["z"]
    log(f"zero gpt2: step (forward, backward, DistributedFusedAdam) "
        f"{rec['timed_ms']:.2f} ms = "
        f"{GPT2_BATCH * GPT2_SEQ / rec['timed_ms'] * 1e3:.1f} tokens/s, peak "
        f"{rec['peak_gib']:.2f} GiB (gpt2_training's FusedAdam step beside it "
        f"in the same run)")
    for world in (1, 8):
        r = z.opt.state_bytes(params, world=world)
        log(f"zero gpt2: state_bytes(world={world}): n {r['n_elements']}, "
            f"padded {r['padded_elements']}, sharded "
            f"{r['sharded_state_bytes']} B (residual {r['residual_bytes']}), "
            f"unsharded {r['unsharded_state_bytes']} B, ratio "
            f"{r['savings_ratio']:.4f}")
    _zero_round_trip("zero gpt2", z.opt, z.state, params)
    del z, holder
    torch.cuda.empty_cache()

    # step 1 from the same weights and gradients: ZeRO against FusedAdam
    init_weights(model, SEED)
    w0 = [p.detach().clone() for p in params]
    g1 = _step1_grads(model, loss_of)
    zopt = DistributedFusedAdam(lr=GPT2_LR, compress=True)
    new_z, _ = zopt.step(g1, zopt.init(w0), w0)
    fused = [torch.nn.Parameter(w.clone()) for w in w0]
    for p, g in zip(fused, g1):
        p.grad = g.clone()
    FusedAdam(fused, lr=GPT2_LR).step()
    ulps, share = _ulps_apart(new_z, [p.detach() for p in fused])
    log(f"zero gpt2: step 1 from the same gradients, DistributedFusedAdam "
        f"(one #12 launch on the flat vector) vs FusedAdam (one a table of "
        f"64 tensors): {share:.3e} of the entries differ, largest "
        f"{ulps:.3f} fp32 ulp (bit-identical expected: the same bias "
        f"corrections, ops.multi_tensor.bias_corrections, and elementwise "
        f"arithmetic)")
    assert share == 0.0, (share, ulps)
    del new_z, fused, g1, w0
    torch.cuda.empty_cache()
    return launches


def _range_order(fn):
    """The ``ddp_overlap_*`` profiler ranges of one call of ``fn``, in the
    order they opened on the host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    found = [e for e in prof.events() if e.name.startswith("ddp_overlap_")]
    return [e.name for e in sorted(found, key=lambda e: e.time_range.start)]


def _zero_gpt2_overlapped():
    """overlapped_zero_step over mesh2d's GPT-2 345M segments on a 1 x 1
    mesh, DistributedFusedAdam(overlap=True, compress=True): counted,
    timed, profiled; step 1 against the plain versions and against the
    monolithic ZeRO step; the ranges' order."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.parallel import mesh2d, overlapped_zero_step
    from apex_tpu_torch.parallel.distributed import _leaves, _rebuild
    m = TP_GPT2_MODEL
    head_dim = m["hidden"] // m["heads"]
    with tp_mesh() as mesh:
        seg = mesh2d.gpt2_init(**m)
        tokens, labels = mesh2d.make_batch(
            mesh, batch_per_replica=TP_GPT2_BATCH, seq=m["max_seq"],
            vocab=m["vocab"])
        segments = mesh2d.gpt2_segments(labels, m["layers"], head_dim)
        kw = dict(lr=GPT2_LR, compress=True)
        opt = DistributedFusedAdam(overlap=True, **kw)
        plan = opt.overlap_plan(list(seg))
        B = sum(len(s) for s in plan)
        n = sum(p.numel() for p in _leaves(seg))
        log(f"zero gpt2 overlapped: mesh2d GPT-2 {m}, {n} fp32 parameters in "
            f"{len(seg)} segments, B = {B} buckets of at most "
            f"{opt.message_size} elements (a segment's buckets never span "
            f"it); batch {TP_GPT2_BATCH} x {m['max_seq']}")

        def run(sp, state):
            return overlapped_zero_step(segments, sp, opt, state, tokens)

        expected = {**dict.fromkeys(registry.launches(), 0), "adam": B}
        sp, state = list(seg), opt.init(list(seg))
        losses, totals, step_ms = [], dict.fromkeys(expected, 0), []
        for k in range(COUNTED_STEPS):
            registry.reset()
            ms, (loss, new_sp, state) = _wall_ms(lambda: run(sp, state))
            if k == 0:
                sp1 = new_sp
            sp = new_sp
            got = registry.launches()
            assert got == expected, (k, got, expected)
            for name in totals:
                totals[name] += got[name]
            losses.append(loss.item())
            step_ms.append(ms)
        assert losses[-1] < losses[0], losses
        torch.cuda.reset_peak_memory_stats()
        timed = []
        for _ in range(TIMED_STEPS):
            ms, (loss, sp, state) = _wall_ms(lambda: run(sp, state))
            timed.append(ms)
        med = statistics.median(timed)
        tokens_n = TP_GPT2_BATCH * m["max_seq"]
        log(f"zero gpt2 overlapped: {COUNTED_STEPS} counted steps, launches "
            f"per step { {k: v for k, v in expected.items() if v} } (every "
            f"step: #12 once a bucket); losses {losses}; step ms {step_ms}; "
            f"timed step {_spread(timed)} = {tokens_n / med * 1e3:.1f} "
            f"tokens/s (host clock, synchronized); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        order = _range_order(lambda: run(sp, state))
        want, b_no = [], B
        for k in reversed(range(len(seg))):
            want.append(f"ddp_overlap_segment_{k}")
            b_no -= len(plan[k])
            want += [f"ddp_overlap_bucket_{b_no + i}"
                     for i in range(len(plan[k]))]
        log(f"zero gpt2 overlapped: profiler ranges in host order "
            f"{order[:6]} ... {order[-4:]} ({len(order)}); each segment's "
            f"buckets open before the next earlier segment's backward")
        assert order == want, (order, want)
        profile_window("zero gpt2 overlapped step", lambda: run(sp, state),
                       top=8, watch=("adam_vec_kernel", "gemm", "softmax"),
                       ranges=("ddp_overlap_segment_23",
                               "ddp_overlap_bucket_0"))
        del sp, state
        torch.cuda.empty_cache()

        # step 1 again: through the plain versions, and as the monolithic
        # ZeRO step on the same model and batch (one backward)
        registry.reset()
        with plain_versions():
            _, sp_plain, _ = overlapped_zero_step(
                segments, list(seg), opt, opt.init(list(seg)), tokens)
        assert not any(registry.launches().values()), registry.launches()
        worst = max(max_rel(a, b) for a, b in zip(_leaves(sp1),
                                                  _leaves(sp_plain)))
        del sp_plain
        leaves = [p.detach().requires_grad_() for p in _leaves(seg)]
        tree = _rebuild(seg, leaves)
        loss = mesh2d.gpt2_loss(tree, tokens, labels, head_dim)
        grads = _rebuild(seg, torch.autograd.grad(loss, leaves))
        mono = DistributedFusedAdam(**kw)
        sp_mono, _ = mono.step(list(grads), mono.init(list(seg)), list(seg))
        ulps, share = _ulps_apart(_leaves(sp1), _leaves(sp_mono))
        log(f"zero gpt2 overlapped: step 1 vs the plain versions: largest "
            f"relative difference {worst:.3e} (tolerance {ADAM_RTOL}); vs "
            f"the monolithic DistributedFusedAdam step on the whole "
            f"model's gradients: loss {loss.item():.6f} vs {losses[0]:.6f}, "
            f"{share:.3e} of the params differ, largest {ulps:.3f} ulp "
            f"(bit-identical expected: the segmented backward runs the "
            f"same ops, Adam is elementwise)")
        assert worst <= ADAM_RTOL, worst
        assert loss.item() == losses[0] and share == 0.0, (share, ulps)
        del sp1, sp_mono, grads, leaves, tree, seg
        torch.cuda.empty_cache()
    return totals


def phase_zero_gpt2():
    """GPT-2 345M as phase_gpt2_training runs it (8 x 1024, flash on, lr
    1e-4) on a one-rank NCCL group with DistributedFusedAdam(compress=True)
    (#12 once a step), then overlapped_zero_step over mesh2d's GPT-2 345M
    segments (#12 once a bucket)."""
    import numpy as np

    from apex_tpu_torch.models import GPTModel, TransformerConfig, gpt_loss_fn
    cfg = TransformerConfig(**GPT2, compute_dtype=torch.bfloat16,
                            use_flash_attention=True)
    with one_rank_group():
        model = _new_model("zero gpt2", lambda: GPTModel(cfg))
        rng = np.random.RandomState(SEED)  # bench_gpt2's batch
        shape = (GPT2_BATCH, GPT2_SEQ)
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
        labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
        L = cfg.num_layers
        per_step = {"layer_norm": 2 * L + 1, "ln_bwd": 2 * L + 1,
                    "flash_fwd": L, "flash_dq": L, "flash_dkv": L, "adam": 1}
        launches = {"zero_gpt2": _zero_gpt2_monolithic(
            model, lambda: gpt_loss_fn(model(tokens), labels), per_step)}
        del model
        torch.cuda.empty_cache()
    launches["zero_gpt2_overlapped"] = _zero_gpt2_overlapped()
    return launches


def phase_zero_bert():
    """BERT-large as phase_bert_training runs it (64 x 128) on a one-rank
    NCCL group with DistributedFusedLAMB(compress=True) (#13 once a step),
    then step 1 against FusedLAMB's from the same gradients."""
    import math

    import numpy as np

    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.models import (
        BertModel,
        TransformerConfig,
        bert_loss_fn,
        init_weights,
    )
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.enums import AttnMaskType
    cfg = TransformerConfig(**BERT, compute_dtype=torch.bfloat16,
                            use_flash_attention=False,
                            attn_mask_type=AttnMaskType.padding)
    kw = dict(lr=BERT_LR, weight_decay=BERT_WD, eps=BERT_EPS,
              max_grad_norm=BERT_MAX_GRAD_NORM)
    with one_rank_group():
        model = _new_model("zero bert", lambda: BertModel(cfg))
        b, s = BERT_BATCH, BERT_SEQ
        rng = np.random.RandomState(SEED)  # bench_bert's inputs, in its order
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
        padding_mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
        tokentype = torch.zeros(b, s, dtype=torch.long, device="cuda")
        labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).cuda()
        loss_mask = torch.from_numpy(
            (rng.rand(b, s) < 0.15).astype(np.float32)).cuda()
        nsp_labels = torch.from_numpy(rng.randint(0, 2, (b,))).cuda()

        def loss_of():
            mlm, nsp = model(tokens, padding_mask, tokentype)
            return bert_loss_fn(mlm, nsp, labels, loss_mask, nsp_labels)

        def linear_below(g1):  # as phase_bert_training's
            norm = math.sqrt(sum(g.cuda().double().square().sum().item()
                                 for g in g1.values()))
            return BERT_EPS * max(norm / BERT_MAX_GRAD_NORM, 1.0)

        L = cfg.num_layers
        per_step = {"layer_norm": 2 * L + 2, "ln_bwd": 2 * L + 2,
                    "masked_softmax": L, "softmax_bwd": L, "lamb": 1}
        launches = train_steps(
            "zero bert", model, loss_of,
            lambda ps: _ZeroOpt(DistributedFusedLAMB(compress=True, **kw), ps),
            per_step, (b, "samples"),
            update_rtol=(LAMB_UPDATE_RTOL, LAMB_TENSOR_UPDATE_RTOL),
            falls_from=1, linear_below=linear_below, record=(rec := {}),
            watch=PROFILE_WATCH + ("direct_copy_kernel", "foreach"))
        log(f"zero bert: step (forward, backward, DistributedFusedLAMB) "
            f"{rec['timed_ms']:.2f} ms = {b / rec['timed_ms'] * 1e3:.1f} "
            f"samples/s, peak {rec['peak_gib']:.2f} GiB")

        params = list(model.parameters())
        init_weights(model, SEED)
        w0 = [p.detach().clone() for p in params]
        g1 = _step1_grads(model, loss_of)
        zopt = DistributedFusedLAMB(compress=True, **kw)
        new_z, _ = zopt.step(g1, zopt.init(w0), w0)
        fused = [torch.nn.Parameter(w.clone()) for w in w0]
        for p, g in zip(fused, g1):
            p.grad = g.clone()
        FusedLAMB(fused, **kw).step()
        excess = _lamb_excess(new_z, [p.detach() for p in fused], w0)
        ulps, share = _ulps_apart(new_z, [p.detach() for p in fused])
        log(f"zero bert: step 1 from the same gradients, DistributedFusedLAMB "
            f"(one #13 launch on the flat vector) vs FusedLAMB: {share:.3e} "
            f"of the entries differ, largest {ulps:.3f} fp32 ulp; past one "
            f"ulp by at most {excess:.3e} of the update (limit "
            f"{ZERO_VS_FUSED_LAMB_RTOL}, tests/test_torch_zero.py)")
        assert excess <= ZERO_VS_FUSED_LAMB_RTOL, excess
        del model, params, w0, g1, new_z, fused
        torch.cuda.empty_cache()
    return {"zero_bert": launches}


# ------------------------------------------------- tensor parallelism

# bench.py bench_tp_dp (bench.py:1897; its CLI batch 4): mesh2d's GPT-2
# block stack at hidden 256, 4 layers, 8 heads, vocab 256, 32 positions,
# the int8 DP sync on "data", SGD at lr 0.05, 10 timed steps
TP_DP_MODEL = dict(hidden=256, layers=4, heads=8, vocab=256, max_seq=32)
TP_DP_BATCH, TP_DP_STEPS = 4, 10
# mesh2d's model at GPT-2 345M widths (bench_gpt2: 24 x 1024, 16 heads,
# vocab 50304, 1024 positions), a batch of 8 x 1024 tokens
TP_GPT2_MODEL = dict(hidden=1024, layers=24, heads=16, vocab=50304,
                     max_seq=1024)
TP_GPT2_BATCH = 8
# the fused and unfused steps' losses: at step 1 the two forwards differ
# only in #20 against cuBLAS in the row-parallel products, fp32 sums in
# another order: 1e-5 relative (a skipped K step or a shifted tile moves
# the loss by far more). Later steps also carry the int8 sync's codes
# that round the other way where the two gradients straddle a boundary
# of their block's grid, each a step of lr x the block's scale in some
# weight, and SGD at lr 0.05 compounds them as the loss falls from 5.9
# to 0.74 in 13 steps: the runs drift apart to 8.0e-4 relative by step 12
# on an H100 80GB HBM3 at 700 W; held to 4e-3 (5x that). The phase
# shows the cause and the limit's reach: with an fp32 sync (no int8
# codes) the same two runs stay within 6.5e-7 at every step, and are held
# to the step-1 limit at every step; of the planted #20 faults
# (TP_DP_FAULTS), a skipped K step reads 1.4e-2 at step 1 and up to 0.22
# after, past both limits, and bf16 operands read 6.4e-5 at step 1, seen
# there only (3.5e-3 at most after, under 4e-3). The step-1 loss and
# gradients of the kernels against the plain versions: TRAIN_LOSS_RTOL
# and 1e-4 (Frobenius; fp32 throughout).
TP_FIRST_LOSS_RTOL, TP_LOSS_RTOL, TP_GRAD_RTOL = 1e-5, 4e-3, 1e-4


def _skip_last_k_terms(real):
    """#20 with its contraction 16 terms short (the first design's K
    step; half of the redesign's)."""
    def fault(x, w):
        out = _tp_matmul_raw(x.reshape(-1, x.shape[-1]), w, w.shape[0] - 16)
        return out.reshape(*x.shape[:-1], w.shape[1])
    return fault


def _bf16_operands(real):
    """#20 on operands rounded to bf16, as a tensor-core product would
    read them."""
    return lambda x, w: real(x.bfloat16(), w.bfloat16()).float()


# planted into the fused tp_dp run in place of #20: each must fail the
# fused-vs-unfused loss hold (step 1 or a later step)
TP_DP_FAULTS = (("#20 skips its last 16 K terms", _skip_last_k_terms),
                ("#20 rounds its operands to bf16", _bf16_operands))


@contextlib.contextmanager
def tp_mesh():
    """mesh2d's 1 x 1 (data, model) mesh on a one-rank NCCL group; the axis
    names unbound again after the phase."""
    from apex_tpu_torch.parallel import groups, mesh2d
    with one_rank_group():
        try:
            yield mesh2d.mesh_2d(1, 1)
        finally:
            for axis in (mesh2d.DATA_AXIS, mesh2d.MODEL_AXIS):
                groups.register_axis(axis, None)


@contextlib.contextmanager
def _tp_all_reduces(into):
    """Record the all-reduces of 3-D activations (the TP row-parallel
    tiles; the DP sync reduces flat buffers) into ``into``: the host
    seconds of each call."""
    import torch.distributed as dist
    real = dist.all_reduce

    def counted(t, *a, **k):
        if t.dim() != 3:
            return real(t, *a, **k)
        t0 = time.perf_counter()
        out = real(t, *a, **k)
        into.append(time.perf_counter() - t0)
        return out

    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = real


def _tp_expected(layers, fused, buckets):
    """Each kernel's launches in one mesh2d step: 4 tiles of #20 for each
    of the 2 row-parallel projections a layer with ``fused``; one #14 and
    one #15 for each int8 bucket of the DP sync."""
    from apex_tpu_torch.kernels import registry
    return {**dict.fromkeys(registry.launches(), 0),
            "tp_matmul": 8 * layers if fused else 0,
            "quantize_int8": buckets, "dequantize_int8": buckets}


def _tp_steps(label, step, state, batch, expected, timed):
    """COUNTED_STEPS steps with the counts set to 0 before each and checked
    after it (and the TP all-reduces of activations counted), then
    ``timed`` steps on the host clock, synchronized. Returns (losses,
    launch totals, step ms list, state, TP all-reduces a step, their host
    ms a step)."""
    from apex_tpu_torch.kernels import registry
    sp, res = state
    losses, totals, per_step, host = [], dict.fromkeys(expected, 0), [], []
    for k in range(COUNTED_STEPS):
        calls = []
        registry.reset()
        with _tp_all_reduces(calls):
            sp, res, loss = step(sp, res, *batch)
            losses.append(loss.item())
        got = registry.launches()
        assert got == expected, (label, k, got, expected)
        for name in totals:
            totals[name] += got[name]
        per_step.append(len(calls))
        host.append(sum(calls) * 1e3)
    assert len(set(per_step)) == 1, per_step
    ms = []
    for _ in range(timed):
        t, (sp, res, loss) = _wall_ms(lambda: step(sp, res, *batch))
        ms.append(t)
        losses.append(loss.item())
    assert all(math.isfinite(v) for v in losses), losses
    return (losses, totals, ms, (sp, res), per_step[0],
            statistics.median(host))


def _tp_dp_losses(mesh, seg, batch, fused, compress="int8"):
    """The losses of COUNTED_STEPS + TP_DP_STEPS tp_dp steps (baseline
    mode), uncounted: the runs the honest ones are compared with."""
    from apex_tpu_torch.parallel import mesh2d
    step, (sp, res) = mesh2d.build_train_step(
        mesh, seg, hidden=TP_DP_MODEL["hidden"], heads=TP_DP_MODEL["heads"],
        mode="baseline", fused=fused, compress=compress)
    losses = []
    for _ in range(COUNTED_STEPS + TP_DP_STEPS):
        sp, res, loss = step(sp, res, *batch)
        losses.append(loss.item())
    return losses


def _rel_diffs(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def _tp_buckets(seg, mode):
    """The DP sync's buckets a step: the bucketed sync's over every leaf
    (baseline), or the overlapped step's, a segment's never spanning it."""
    from apex_tpu_torch.parallel import plan_buckets, plan_overlap
    from apex_tpu_torch.parallel.distributed import _leaves
    if mode == "baseline":
        return len(plan_buckets(_leaves(seg), DDP_MESSAGE_SIZE))
    return sum(len(s) for s in plan_overlap(list(seg),
                                            message_size=DDP_MESSAGE_SIZE))


def phase_tp_dp():
    """bench.py bench_tp_dp's 2-D step on a 1 x 1 mesh (one-rank NCCL
    group): int8 on "data", mode "baseline" and "overlapped" (JAX's
    default: each layer's buckets synced as its backward ends), fused off
    and on in each, 3 counted and 10 timed steps each; each mode's two
    runs' losses held step by step, and the overlapped runs' equal to the
    baseline's at every step. Then the baseline pair with an fp32 sync, held to the
    step-1 limit at every step, and the fused baseline run with each of
    TP_DP_FAULTS planted, which must fail the int8 pair's hold."""
    from apex_tpu_torch.kernels import fused_cc
    from apex_tpu_torch.parallel import mesh2d
    m = TP_DP_MODEL
    launches, runs, faults = {}, {}, {}
    with tp_mesh() as mesh:
        seg = mesh2d.gpt2_init(**m)
        batch = mesh2d.make_batch(mesh, batch_per_replica=TP_DP_BATCH,
                                  seq=m["max_seq"], vocab=m["vocab"])
        for mode, fused in (("baseline", False), ("baseline", True),
                            ("overlapped", False), ("overlapped", True)):
            buckets = _tp_buckets(seg, mode)
            name = ("fused" if fused else "unfused") + (
                "" if mode == "baseline" else "_overlapped")
            step, state = mesh2d.build_train_step(
                mesh, seg, hidden=m["hidden"], heads=m["heads"],
                mode=mode, fused=fused)
            expected = _tp_expected(m["layers"], fused, buckets)
            losses, totals, ms, (sp, res), tp_calls, tp_ms = _tp_steps(
                f"tp_dp {name}", step, state, batch, expected, TP_DP_STEPS)
            runs[name] = losses
            launches[f"tp_dp_{name}"] = totals
            log(f"tp_dp {name}: {m}, batch {TP_DP_BATCH} x {m['max_seq']}, "
                f"mode {mode!r}, int8 sync ({buckets} buckets): launches per "
                f"step "
                f"{ {k: v for k, v in expected.items() if v} } (every "
                f"counted step); TP all-reduces a step {tp_calls} "
                f"({tp_ms:.2f} ms of host time, median of the counted "
                f"steps); {TP_DP_STEPS} steps {_spread(ms)} = "
                f"{1e3 / statistics.median(ms):.1f} steps/s (host clock, "
                f"synchronized); losses {runs[name]}")
            profile_window(f"tp_dp {name} step",
                           lambda: step(sp, res, *batch), top=5,
                           watch=("matmul_kernel<", "gemm", "nccl"))
        fp32_sync = _rel_diffs(
            _tp_dp_losses(mesh, seg, batch, True, compress=None),
            _tp_dp_losses(mesh, seg, batch, False, compress=None))
        for name, fault in TP_DP_FAULTS:
            real = fused_cc._matmul
            fused_cc._matmul = fault(real)
            try:
                faults[name] = _rel_diffs(
                    _tp_dp_losses(mesh, seg, batch, True), runs["unfused"])
            finally:
                fused_cc._matmul = real

    def fmt(diffs):
        return [float(f"{d:.3e}") for d in diffs]

    diffs = _rel_diffs(runs["fused"], runs["unfused"])
    log(f"tp_dp: fused vs unfused losses, relative differences step by "
        f"step: {fmt(diffs)} (limits {TP_FIRST_LOSS_RTOL} at step 1, "
        f"{TP_LOSS_RTOL} after); with an fp32 sync: {fmt(fp32_sync)} "
        f"(limit {TP_FIRST_LOSS_RTOL} at every step)")
    ovl = _rel_diffs(runs["fused_overlapped"], runs["unfused_overlapped"])
    vs_base = {f: _rel_diffs(runs[f"{f}_overlapped"], runs[f])
               for f in ("fused", "unfused")}
    log(f"tp_dp overlapped: fused vs unfused losses {fmt(ovl)} (the same "
        f"limits); overlapped vs baseline, fused {fmt(vs_base['fused'])}, "
        f"unfused {fmt(vs_base['unfused'])} (equal expected at every step: "
        f"every leaf is a multiple of 256 elements, so the layers' buckets "
        f"cut the baseline's bucket on its int8 block grid, and the folded "
        f"average multiplies the scales by 1.0 at world 1)")
    assert ovl[0] <= TP_FIRST_LOSS_RTOL and max(ovl) <= TP_LOSS_RTOL, ovl
    assert all(max(d) == 0.0 for d in vs_base.values()), vs_base
    for f in ("fused_overlapped", "unfused_overlapped"):
        assert runs[f][-1] < runs[f][0], runs[f]
    for name, d in faults.items():
        log(f"tp_dp: planted fault ({name}): fused vs unfused losses "
            f"{fmt(d)}")
    assert diffs[0] <= TP_FIRST_LOSS_RTOL, diffs
    assert max(diffs) <= TP_LOSS_RTOL, diffs
    assert max(fp32_sync) <= TP_FIRST_LOSS_RTOL, fp32_sync
    assert all(d[0] > TP_FIRST_LOSS_RTOL or max(d) > TP_LOSS_RTOL
               for d in faults.values()), faults
    assert any(max(d[1:]) > TP_LOSS_RTOL for d in faults.values()), faults
    assert runs["fused"][-1] < runs["fused"][0], runs["fused"]
    return launches


def _named_leaves(tree, prefix=""):
    """The dotted names of ``tree``'s leaves in jax.tree_util order (dicts
    by sorted key, as ``parallel.distributed`` flattens them)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _named_leaves(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _tp_grads(shards, batch, head_dim, held):
    """The loss of one fused forward on ``shards`` and the gradients of the
    leaves named in ``held``."""
    from apex_tpu_torch.parallel import mesh2d
    from apex_tpu_torch.parallel.distributed import _leaves, _rebuild
    leaves = [p.detach().requires_grad_() for p in _leaves(shards)]
    loss = mesh2d.gpt2_loss(_rebuild(shards, leaves), *batch, head_dim,
                            fused=True)
    grads = torch.autograd.grad(loss, leaves)
    names = _named_leaves(shards)
    return loss.item(), {n: g for n, g in zip(names, grads) if n in held}


def phase_tp_gpt2():
    """mesh2d's 2-D step at GPT-2 345M widths (8 x 1024 tokens) on a 1 x 1
    mesh, fused, int8 on "data": step 1's loss and gradients held against
    the plain versions; 3 counted steps (#20 192 a step), 5 timed, a
    profile; one unfused step's loss against the fused step 1's, then 5
    unfused steps timed: the fused and unfused medians and their
    ratio."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.parallel import mesh2d, plan_buckets
    from apex_tpu_torch.parallel.distributed import _leaves
    m = TP_GPT2_MODEL
    head_dim = m["hidden"] // m["heads"]
    with tp_mesh() as mesh:
        t0 = time.perf_counter()
        seg = mesh2d.gpt2_init(**m)
        n = sum(p.numel() for p in _leaves(seg))
        buckets = len(plan_buckets(_leaves(seg), DDP_MESSAGE_SIZE))
        batch = mesh2d.make_batch(mesh, batch_per_replica=TP_GPT2_BATCH,
                                  seq=m["max_seq"], vocab=m["vocab"])
        log(f"tp_gpt2: mesh2d GPT-2 {m}: {n} fp32 parameters drawn in "
            f"{time.perf_counter() - t0:.1f} s; batch {TP_GPT2_BATCH} x "
            f"{m['max_seq']}; int8 sync in {buckets} buckets")
        # step 1's loss and gradients, kernels against plain versions
        held = {"0.embed.wte", "0.layer.attn.wo", "0.layer.attn.wq",
                f"{m['layers'] - 1}.layer.mlp.wi",
                f"{m['layers'] - 1}.layer.mlp.wo", f"{m['layers'] - 1}.head.w"}
        registry.reset()
        loss_k, g_k = _tp_grads(seg, batch, head_dim, held)
        assert registry.launches()["tp_matmul"] == 8 * m["layers"]
        torch.cuda.synchronize()
        registry.reset()
        with plain_versions():
            loss_p, g_p = _tp_grads(seg, batch, head_dim, held)
        assert not any(registry.launches().values()), registry.launches()
        assert g_k.keys() == held, sorted(g_k)
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        grad_err = {n: _rel_fro(g_k[n], g_p[n]) for n in sorted(held)}
        del g_k, g_p
        log(f"tp_gpt2: step 1 kernels vs plain versions: loss {loss_k:.6f} "
            f"vs {loss_p:.6f} (rel err {loss_err:.3e}, limit "
            f"{TRAIN_LOSS_RTOL}); gradients (rel Frobenius) "
            + ", ".join(f"{n} {e:.3e}" for n, e in grad_err.items())
            + f" (limit {TP_GRAD_RTOL})")
        assert loss_err <= TRAIN_LOSS_RTOL, loss_err
        assert max(grad_err.values()) <= TP_GRAD_RTOL, grad_err
        torch.cuda.empty_cache()

        step, state = mesh2d.build_train_step(
            mesh, seg, hidden=m["hidden"], heads=m["heads"],
            mode="baseline", fused=True)
        expected = _tp_expected(m["layers"], True, buckets)
        torch.cuda.reset_peak_memory_stats()
        losses, totals, ms, state, tp_calls, tp_ms = _tp_steps(
            "tp_gpt2", step, state, batch, expected, TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        assert tp_calls == 8 * m["layers"], tp_calls
        med = statistics.median(ms)
        tokens = TP_GPT2_BATCH * m["max_seq"]
        log(f"tp_gpt2 fused: launches per step "
            f"{ {k: v for k, v in expected.items() if v} } (every counted "
            f"step); TP all-reduces a step {tp_calls} (4 column tiles of "
            f"each row-parallel projection, all in the forward; the region "
            f"ops are the identity at world 1), {tp_ms:.2f} ms of host time; "
            f"step {_spread(ms)} = "
            f"{tokens / med * 1e3:.1f} tokens/s (host clock, synchronized); "
            f"peak memory {peak:.2f} GiB; losses {losses}")
        assert losses[COUNTED_STEPS - 1] < losses[0], losses
        sp, res = state
        stats = profile_window(
            "tp_gpt2 fused step", lambda: step(sp, res, *batch), top=10,
            watch=("matmul_kernel<", "gemm", "softmax", "nccl", "quant"))
        if stats:
            us = stats["watch"]["matmul_kernel<"]
            log(f"tp_gpt2: #20 {us / 1e3:.3f} ms on the device a step "
                f"({us / stats['busy_us']:.4f} of the busy time, "
                f"{us / (8 * m['layers']):.2f} us a launch)")
        del step, state, sp, res
        torch.cuda.empty_cache()

        # the overlapped step (JAX's default mode), fused, from the same
        # parameters: each layer's buckets synced as its backward ends
        ob = _tp_buckets(seg, "overlapped")
        step, state = mesh2d.build_train_step(
            mesh, seg, hidden=m["hidden"], heads=m["heads"],
            mode="overlapped", fused=True)
        expected_o = _tp_expected(m["layers"], True, ob)
        torch.cuda.reset_peak_memory_stats()
        losses_o, totals_o, ms_o, state, tp_calls_o, _ = _tp_steps(
            "tp_gpt2 overlapped", step, state, batch, expected_o, TIMED_STEPS)
        peak_o = torch.cuda.max_memory_allocated() / 2**30
        med_o = statistics.median(ms_o)
        diff_o = abs(losses_o[0] - losses[0]) / abs(losses[0])
        log(f"tp_gpt2 overlapped: launches per step "
            f"{ {k: v for k, v in expected_o.items() if v} } (every counted "
            f"step; {ob} buckets, a layer's never spanning it); TP "
            f"all-reduces a step {tp_calls_o}; step {_spread(ms_o)} = "
            f"{tokens / med_o * 1e3:.1f} tokens/s (host clock, "
            f"synchronized); overlapped median {med_o:.2f} ms / baseline "
            f"median {med:.2f} ms = {med_o / med:.4f}; peak memory "
            f"{peak_o:.2f} GiB; losses {losses_o}, the baseline's at every "
            f"step expected (every leaf a multiple of 256 elements: the same "
            f"int8 grid; the folded average a product by 1.0 at world 1); "
            f"step 1 {diff_o:.3e} apart")
        assert losses_o == losses, (losses_o, losses)
        assert losses_o[COUNTED_STEPS - 1] < losses_o[0], losses_o
        sp, res = state
        profile_window(
            "tp_gpt2 overlapped step", lambda: step(sp, res, *batch), top=6,
            watch=("matmul_kernel<", "quant"),
            ranges=(f"ddp_overlap_segment_{m['layers'] - 1}",
                    "ddp_overlap_bucket_0"))
        del step, state, sp, res
        torch.cuda.empty_cache()

        # one unfused step from the same parameters
        step, state = mesh2d.build_train_step(
            mesh, seg, hidden=m["hidden"], heads=m["heads"],
            mode="baseline", fused=False)
        registry.reset()
        ms_u, (_, _, loss_u) = _wall_ms(lambda: step(*state, *batch))
        assert registry.launches()["tp_matmul"] == 0
        # the same step from the same state, timed as the fused ones
        ms_again = [_wall_ms(lambda: step(*state, *batch))[0]
                    for _ in range(TIMED_STEPS)]
        med_u = statistics.median(ms_again)
        diff = abs(loss_u.item() - losses[0]) / abs(loss_u.item())
        log(f"tp_gpt2 unfused: step 1 loss {loss_u.item():.6f} vs fused "
            f"{losses[0]:.6f} (rel diff {diff:.3e}, limit "
            f"{TP_FIRST_LOSS_RTOL}); "
            f"step {ms_u:.2f} ms, then {_spread(ms_again)} (host clock, "
            f"synchronized); fused median {med:.2f} ms / unfused median "
            f"{med_u:.2f} ms = {med / med_u:.4f}")
        assert diff <= TP_FIRST_LOSS_RTOL, diff
        del step, state, seg
        torch.cuda.empty_cache()
    return {"tp_gpt2": totals, "tp_gpt2_overlapped": totals_o}



# kernel name parts whose summed device time a training profile prints
# --------------------------------------------------------------- tp_serve

# tensor-parallel serving at tp = 2 as two ranks sharing the one card over
# a gloo group (NCCL refuses two ranks on one device): each rank is this
# script in worker mode, started by the port's launcher, TinyLlama-1.1B at
# full width and depth from the tp = 1 weights drawn from SEED on the host
TP_WORLD, TP_WORKER_TIMEOUT_S, TP_PROBE_TIMEOUT_S = 2, 900, 120
TP_LABEL = "two ranks sharing one H100 over gloo (not a TP figure)"


def _host_drawn(build):
    """``build(device)`` with its seed-SEED weights drawn on the host, as
    ``init_params_tp`` draws the tp = 1 twin a tp = 2 rank shards, then
    moved to the card."""
    from apex_tpu_torch.models import init_weights
    model = build("cpu")
    init_weights(model, SEED)
    return model.to("cuda")


def _tp_prompt(vocab):
    return torch.randint(0, vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(SEED))


def _mla_prompt(vocab):
    return torch.randint(0, vocab, (MLA_BATCH, MLA_PREFIX),
                         generator=torch.Generator().manual_seed(SEED)).cuda()


def _tp_greedy(model, prompt, steps, feed=None, after_prefill=None):
    """Greedy decode of ``steps`` tokens after ``prompt`` [b, s] through
    ``prefill`` and ``decode_step`` (each step fed ``feed``'s token when
    given; ``after_prefill()`` called between the two, where given):
    (tokens [b, steps], the full-vocabulary fp32 logits [steps, b,
    vocab] each came from, host ms of each synchronized decode step)."""
    from apex_tpu_torch.models import decode_step, init_cache, prefill
    prompt = prompt.cuda()
    b, s = prompt.shape
    cache = init_cache(model, b)
    _, logits = prefill(model, cache, prompt,
                        torch.arange(s, device="cuda")[None])
    if after_prefill is not None:
        after_prefill()
    scores, out, ms = [logits.float()], [], []
    for i in range(steps):
        tok = (torch.argmax(scores[-1], dim=-1) if feed is None
               else feed[:, i].cuda())
        out.append(tok)
        if i + 1 == steps:
            break
        t, (_, logits) = _wall_ms(lambda: decode_step(
            model, cache, tok[:, None],
            torch.full((b, 1), s + i, device="cuda")))
        ms.append(t)
        scores.append(logits.float())
    return torch.stack(out, dim=1), torch.stack(scores), ms


class _CollectiveClock:
    """Host seconds and calls inside torch.distributed's collectives (each
    gloo call until it returns: its copies between the card and the host,
    which wait for the rank's kernels before it, and the exchange),
    patched in for a worker's lifetime."""

    NAMES = ("all_reduce", "all_gather", "broadcast_object_list")

    def __init__(self):
        import torch.distributed as dist
        self.seconds, self.calls = 0.0, 0
        for name in self.NAMES:
            setattr(dist, name, self._timed(getattr(dist, name)))

    def _timed(self, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return run

    def reset(self):
        self.seconds, self.calls = 0.0, 0


def _gloo_on_cuda_probe(rank):
    """gloo's collectives of tensors on the card, as the tp path runs
    them (the region ops' bf16 all_reduce and all_gather, handed to gloo
    as they are), each held bit for bit against the same collective on
    host copies of the same tensors; -0.0 among the values, so a sign
    lost on the way shows."""
    import torch.distributed as dist
    from apex_tpu_torch.transformer.tensor_parallel import mappings
    gen = torch.Generator().manual_seed(SEED + rank)
    x = torch.randn(4096, generator=gen).to(torch.bfloat16)
    x[::7] = -0.0
    world = dist.group.WORLD
    for name, run in (("all_reduce bf16", lambda t: mappings._reduce(t, world)),
                      ("all_gather", lambda t: mappings._gather(t, 0, world))):
        got = run(x.cuda())
        torch.cuda.synchronize()
        assert got.device.type == "cuda", got.device
        want = run(x)
        same = torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
        log(f"tp_serve rank {rank}: gloo {name} on CUDA tensors: accepted; "
            f"bit for bit the same collective on host copies: {same}")
        assert same, name


def _tp_serve_engines(model, vocab, rank, mesh, clock, res):
    """The bf16 and int8 engines at tp = 2 (eager: a gloo collective
    cannot be captured) over the serve_bf16 trace, counted; int8 held
    against its plain versions on this rank."""
    from apex_tpu_torch.serving import ServeEngine
    L = model.num_layers
    try:
        ServeEngine(model, _serve_config(cache_mode="bf16"), mesh=mesh)
    except NotImplementedError as e:
        assert "5(d)" in str(e), e
        log(f"tp_serve rank {rank}: CUDA graph capture at tp 2 refused: {e}")
    else:
        raise AssertionError("a tp = 2 engine captured CUDA graphs")
    for mode in ("bf16", "int8"):
        label = f"tp_serve rank {rank} {mode}"
        engine = _eager_engine(model, _serve_config(cache_mode=mode),
                               mesh=mesh)
        assert engine.tp == TP_WORLD and engine.compile_count == 0
        log(f"{label}: kv_cache_bytes {engine.kv_cache_bytes()} on this rank "
            f"({engine.spec.groups} groups, {engine.spec.blocks} blocks of "
            f"{engine.spec.block} lanes in int8)")
        streams, stats, launches = _serve_counted(label, engine, vocab,
                                                  before=clock.reset)
        steps, calls = stats["decode_steps"], stats["prefill_calls"]
        expected = {"rms_norm": (2 * L + 1) * (steps + calls),
                    "gqa_decode": L * steps, "window_attention": L * calls}
        if mode == "int8":
            expected.update(quantize_int8=2 * L * (steps + calls),
                            dequantize_int8=2 * L * steps)
        _expect(label, launches, expected)
        log(f"{label}: {stats['tokens_per_sec']:.1f} tokens/s, per-token "
            f"latency p50 {stats['tok_latency_p50_ms']:.2f} ms; gloo "
            f"collectives {clock.calls} calls, {clock.seconds * 1e3:.1f} ms "
            f"({clock.seconds / stats['wall_s']:.3f} of the counted run's "
            f"{stats['wall_s'] * 1e3:.1f} ms host time, the warm trace "
            f"excluded: {TP_LABEL})")
        res[f"serve_{mode}"] = streams
        res["launches"][f"serve_{mode}"] = launches
        if mode == "int8":
            from apex_tpu_torch.kernels import quant
            sp = engine.spec
            plans = (quant.quant_plan(BATCH, sp.width, sp.blocks, sp.block,
                                      2, True),
                     quant.dequant_plan(BATCH, sp.width, sp.blocks, sp.block,
                                        1, 2, True))
            log(f"{label}: the rank's {sp.width}-lane rows in {sp.blocks} "
                f"block(s) of {sp.block}: quant_plan {plans[0]}, "
                f"dequant_plan {plans[1]} (vector body {quant.VECTOR})")
            assert plans == (quant.VECTOR, quant.VECTOR), plans
            with plain_versions():
                plain, _ = _eager_engine(model, _serve_config(
                    cache_mode=mode), mesh=mesh).serve(_serve_trace(vocab))
            _margin_check(f"{label} kernels vs plain versions", model,
                          _serve_trace(vocab), streams, _streams(plain))
        del engine
        torch.cuda.empty_cache()


def _tp_spec_prefix(model, vocab, rank, mesh, res):
    """The speculative + prefix engine at tp = 2 over serve_prefix's
    trace (the target's layers past the first scaled by 0.25, in place,
    and a 1-layer draft sharing its shards, as serve_prefix builds them),
    counted, held to the plain tp = 2 engine on the same target."""
    import dataclasses

    from apex_tpu_torch.models import GPTModel
    L = model.num_layers
    with torch.no_grad():
        for i, layer in enumerate(model.transformer.layers):
            if i:
                for p in layer.parameters():
                    p.mul_(0.25)
    draft = GPTModel(dataclasses.replace(model.config, num_layers=1))
    draft.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("transformer.layers.")
                           or k.startswith("transformer.layers.0.")})
    trace = _prefix_trace(vocab, 1)
    label = f"tp_serve rank {rank} spec+prefix"
    engine = _eager_engine(model, _prefix_config(
        cache_mode="bf16", **_prefix_kw(draft)), mesh=mesh)
    streams, stats, launches = _serve_counted(
        label, engine, vocab, trace, _prefix_trace(vocab, 0, n=2))
    rounds, calls = stats["decode_steps"], stats["prefill_calls"]
    feeds = SPEC_K + 1
    _expect(label, launches, {
        "rms_norm": (2 * L + 1 + 3 * feeds) * rounds + (2 * L + 1 + 3) * calls,
        "gqa_decode": feeds * rounds,
        "window_attention": L * rounds + (L + 1) * calls})
    assert stats["prefix_hits"] > 0, stats
    log(f"{label}: acceptance {stats['acceptance_rate']}, prefix hits "
        f"{stats['prefix_hits']} of {stats['prefix_lookups']}")
    del engine
    plain, _ = _eager_engine(model, _prefix_config(cache_mode="bf16"),
                             mesh=mesh).serve(trace)
    _margin_check(f"{label} vs the plain tp 2 engine", model, trace, streams,
                  _streams(plain))
    res["serve_spec_prefix"] = streams
    res["launches"]["serve_spec_prefix"] = launches


def _tp_mla(rank, res):
    """mla_decode's model at tp = 2 (8 of its 16 heads a rank): an 8 x
    4096 prefill and MLA_STEPS + 1 greedy steps, counted, timed, the
    kernel's plan printed."""
    from apex_tpu_torch.contrib import mla_decode
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import (
        DeepseekModel,
        MLAConfig,
        init_params_tp,
        rank_state_dict,
    )
    cfg = MLAConfig(**MLA_DECODE_CFG, params_dtype=torch.float32,
                    compute_dtype=torch.bfloat16)
    model = DeepseekModel(cfg)
    model.load_state_dict(rank_state_dict(init_params_tp(model, SEED), rank))
    n_local = model.layers[0].self_attn.n_local
    prompt = _mla_prompt(cfg.vocab_size)
    registry.reset()
    torch.cuda.synchronize()
    toks, logits = _greedy(model, prompt, MLA_STEPS + 2)
    launches = registry.launches()
    norms = _mla_norms(cfg)
    _expect(f"tp_serve rank {rank} mla_decode", launches, {
        "rms_norm": norms * (MLA_STEPS + 2),
        "mla_decode": cfg.num_layers * (MLA_STEPS + 1)})
    _, cache = model.decode_prefill(prompt)
    lat = cfg.kv_lora_rank
    q = torch.empty(MLA_BATCH, n_local, lat + cfg.qk_rope_head_dim,
                    dtype=torch.bfloat16, device="cuda")
    log(f"tp_serve rank {rank} mla_decode: {n_local} heads a rank, the "
        f"kernel's plan {mla_decode.plan_for(q, cache.latent[0], lat)}")
    _, _, ms = _greedy_steps(model, cache, toks[:, 0], MLA_STEPS)
    log(f"tp_serve rank {rank} mla_decode: decode step {_spread(ms)}, "
        f"{MLA_BATCH * 1e3 / statistics.median(ms):.1f} tokens/s ({TP_LABEL})")
    res["mla"], res["mla_logits"] = toks.cpu(), logits.cpu()
    res["launches"]["mla_decode"] = launches


def _laps(label):
    """``lap(what)`` logs the seconds since the last lap (or this call)."""
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"{label}: {what} in {now - last[0]:.1f} s")
        last[0] = now
    return lap


def tp_worker(out_dir):
    """One rank of tp_serve, started by the launcher: binds cuda:0 on a
    gloo group, initialize_model_parallel(2), runs the tp = 2 paths,
    holds what one rank can hold (launch counts, its kernels against
    their plain versions, near ties against its own model), and writes
    its results for the parent, which holds the two ranks together and
    against tp = 1."""
    import torch.distributed as dist

    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.models import (
        GPTModel,
        TransformerConfig,
        init_params_tp,
        tensor_parallel_beam_search,
        tensor_parallel_generate,
    )
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.serving import ServeMesh
    from apex_tpu_torch.transformer import parallel_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = multiproc.initialize_distributed(device="cuda:0",
                                               backend="gloo")
    rank = dist.get_rank()
    parallel_state.initialize_model_parallel(TP_WORLD)
    t_worker = time.perf_counter()
    lap = _laps(f"tp_serve rank {rank}")
    log(f"tp_serve rank {rank}: {backend} group of {dist.get_world_size()} "
        f"on {torch.cuda.get_device_name(0)}, tp "
        f"{parallel_state.get_tensor_model_parallel_world_size()}")
    _gloo_on_cuda_probe(rank)
    clock = _CollectiveClock()
    res = {"launches": {}}
    cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16)
    model = GPTModel(cfg)  # this rank's shard, on the card
    L, vocab = cfg.num_layers, cfg.vocab_size
    t0 = time.perf_counter()
    stacked = init_params_tp(model, SEED)
    log(f"tp_serve rank {rank}: init_params_tp (the tp 1 weights drawn on "
        f"the host, split) in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters())} parameters a rank")
    prompt = _tp_prompt(vocab)
    tensor_parallel_generate(model, stacked, prompt, 2)  # loads the shard
    del stacked

    # the main path, counted
    registry.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = tensor_parallel_generate(model, None, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = registry.launches()
    _expect(f"tp_serve rank {rank} tensor_parallel_generate", launches, {
        "rms_norm": (2 * L + 1) * NEW_TOKENS, "window_attention": L,
        "gqa_decode": L * (NEW_TOKENS - 1)})
    res["launches"]["generate"] = launches
    assert tokens.shape == (BATCH, PROMPT + NEW_TOKENS)
    assert torch.equal(tokens[:, :PROMPT].cpu(), prompt)
    in_prefill = []

    def prefill_done():  # the prefill's collectives apart from the steps'
        in_prefill.append((clock.calls, clock.seconds))
        clock.reset()

    clock.reset()
    toks, logits, ms = _tp_greedy(model, prompt, NEW_TOKENS,
                                  after_prefill=prefill_done)
    assert torch.equal(toks.cpu(), tokens[:, PROMPT:].cpu())
    med = statistics.median(ms)
    (p_calls, p_s), = in_prefill
    log(f"tp_serve rank {rank}: tensor_parallel_generate ({BATCH}x{PROMPT} "
        f"+ {NEW_TOKENS}) {gen_s * 1e3:.1f} ms; decode step {_spread(ms)} "
        f"= {BATCH / med * 1e3:.1f} tokens/s; gloo collectives: the "
        f"prefill {p_calls} calls, {p_s * 1e3:.1f} ms; the {len(ms)} steps "
        f"{clock.calls} calls, {clock.seconds * 1e3:.1f} ms, "
        f"{clock.seconds * 1e3 / sum(ms):.3f} of the steps' "
        f"{sum(ms):.1f} ms host time ({TP_LABEL})")
    with plain_versions():
        _, plain, _ = _tp_greedy(model, prompt, 2, feed=toks)
    _hold_logits(f"tp_serve rank {rank}: prefill", logits[0], plain[0])
    _hold_logits(f"tp_serve rank {rank}: step 1", logits[1], plain[1])
    res["generate"], res["generate_logits"] = tokens.cpu(), logits.cpu()
    del logits, plain

    tensor_parallel_beam_search(model, None, prompt, 2, BEAMS)  # warm
    registry.reset()
    seqs, scores = tensor_parallel_beam_search(model, None, prompt,
                                               NEW_TOKENS, BEAMS)
    launches = registry.launches()
    _expect(f"tp_serve rank {rank} tensor_parallel_beam_search", launches, {
        "rms_norm": (2 * L + 1) * NEW_TOKENS, "window_attention": L,
        "gqa_decode": L * (NEW_TOKENS - 1)})
    res["launches"]["beam_search"] = launches
    assert torch.isfinite(scores).all() and (scores <= 0).all(), scores
    one, _ = tensor_parallel_beam_search(model, None, prompt, NEW_TOKENS, 1)
    _rows_check(f"tp_serve rank {rank}: one beam vs greedy", model, prompt,
                one[:, PROMPT:], tokens[:, PROMPT:])
    res["beam"], res["beam_scores"] = seqs.cpu(), scores.cpu()

    mesh = ServeMesh.from_grid()
    lap("generate and beam search")
    _tp_serve_engines(model, vocab, rank, mesh, clock, res)
    lap("the bf16 and int8 engines")
    _tp_spec_prefix(model, vocab, rank, mesh, res)
    lap("the speculative + prefix engine")
    # on serve_prefix's scaled target, as serve_prefix's own drill
    _migration_drill(model, vocab, _prefix_trace(vocab, 1),
                     build=lambda c: _eager_engine(model, c, mesh=mesh),
                     label=f"tp_serve rank {rank}")
    lap("the migration drill")
    del model
    torch.cuda.empty_cache()
    _tp_mla(rank, res)
    lap("mla_decode")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    log(f"tp_serve rank {rank}: done in {time.perf_counter() - t_worker:.1f} s")
    return 0


def nccl_probe(out_dir):
    """Two ranks on one card asking for NCCL, as tp_serve would on a
    machine with two cards: each records what NCCL does (run 1 of the
    slice: a duplicate-GPU refusal)."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc
    try:
        multiproc.initialize_distributed(device="cuda:0")
        dist.all_reduce(torch.ones(1, device="cuda"))
        torch.cuda.synchronize()
        outcome = "accepted"
    except Exception as e:  # noqa: BLE001 (recorded: the probe's result)
        outcome = f"refused: {type(e).__name__}: {str(e)[:600]}"
    log(f"nccl probe: {outcome}")
    return 0


def _launch_ranks(mode, out_dir, timeout):
    """Start TP_WORLD ranks of this script in ``mode`` through the port's
    launcher on 127.0.0.1, each logging to a file; wait for all, killing
    every one when one fails or the time runs out. Returns (return
    codes, logs); a timeout returns None for the codes."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs, files = [], []
    for r in range(TP_WORLD):
        f = open(os.path.join(out_dir, f"{mode}{r}.log"), "w")
        files.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
             "--nnodes", str(TP_WORLD), "--node_rank", str(r),
             "--coordinator", f"127.0.0.1:{port}",
             os.path.abspath(__file__), f"--{mode}", out_dir],
            cwd=here, env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    codes = [None] * TP_WORLD
    try:
        while None in codes and time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    logs = [open(os.path.join(out_dir, f"{mode}{r}.log")).read()
            for r in range(TP_WORLD)]
    return (codes if None not in codes else None), logs


def _tp_kernel_entries(gen):
    """The kernels of the tp = 2 path at one rank's shapes, timed in the
    parent alone on the card: #25 and #21 at 16 heads in 2 groups, #14
    and #15 at the int8 store's 128-lane rows, #26 at 8 heads (#6 sees
    the full hidden, replicated: its main-path row stands)."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import fused_cc, quant
    n, g = (MODEL["num_attention_heads"] // TP_WORLD,
            MODEL["num_query_groups"] // TP_WORLD)
    d, rep, T = MODEL["hidden_size"] // MODEL["num_attention_heads"], \
        MODEL["num_attention_heads"] // MODEL["num_query_groups"], \
        MODEL["max_position_embeddings"]
    sm, at = d ** -0.5, f"tp 2 rank ({TP_LABEL})"
    entries = []
    q = _randn(gen, BATCH, g, rep, d)
    k, v = _cache(gen, T, BATCH, g, d, DECODE_LENGTH)
    lengths = _rows(BATCH, DECODE_LENGTH)
    got = gqa_decode.gqa_flash_decode(q, k, v, lengths, sm)
    want = gqa_decode.gqa_decode_plain(q, k, v, DECODE_LENGTH, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    q_l, k_l, v_l = (q.reshape(BATCH, n, 1, d),
                     k[:DECODE_LENGTH].permute(1, 2, 0, 3),
                     v[:DECODE_LENGTH].permute(1, 2, 0, 3))
    entries.append(entry(
        "gqa_decode", f"{at}: q[{BATCH},{g},{rep},{d}] bf16, cache[{T},"
        f"{BATCH},{g},{d}] bf16, length {DECODE_LENGTH}", got, want,
        f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: gqa_decode.gqa_flash_decode(q, k, v, lengths, sm),
        lambda: gqa_decode.gqa_decode_plain(q, k, v, lengths, sm),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q_l, k_l, v_l, scale=sm, enable_gqa=True),
        _attention_bound(BATCH, g, rep, d, 1, DECODE_LENGTH - 1, None)))
    qw = _randn(gen, PROMPT, BATCH, g, rep, d)
    kw, vw = _cache(gen, T, BATCH, g, d, PROMPT)
    start = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    got = fused_cc.window_attention(qw, kw, vw, start, sm)
    want = fused_cc.window_attention_plain(qw, kw, vw, 0, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    qw_l = qw.reshape(PROMPT, BATCH, n, d).permute(1, 2, 0, 3)
    kw_l, vw_l = (kw[:PROMPT].permute(1, 2, 0, 3),
                  vw[:PROMPT].permute(1, 2, 0, 3))
    entries.append(entry(
        "window_attention", f"{at}: qg[{PROMPT},{BATCH},{g},{rep},{d}] bf16, "
        f"cache[{T},{BATCH},{g},{d}] bf16, start 0", got, want,
        f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: fused_cc.window_attention(qw, kw, vw, start, sm),
        lambda: fused_cc.window_attention_plain(qw, kw, vw, start, sm),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qw_l, kw_l, vw_l, is_causal=True, scale=sm, enable_gqa=True),
        _attention_bound(BATCH, g, rep, d, PROMPT, 0, None)))
    del q, k, v, qw, kw, vw, q_l, k_l, v_l, qw_l, kw_l, vw_l
    # the int8 store's rows of one rank: a prefill bucket's T x b rows of
    # g * d = 128 lanes, one block each
    width, rows = g * d, T * BATCH
    x = _randn(gen, rows, width)
    qc, sc = quant.quantize_rows(x, width)
    qp, sp = quant.quantize_rows_plain(x, width)
    assert torch.equal(qc, qp) and torch.equal(sc, sp)
    qbytes = _quant_bytes(rows, width, width, 2)
    entries.append(entry(
        "quantize_int8", f"{at}: x[{rows},{width}] bf16, block {width}",
        qc.float(), qp.float(), "bit for bit",
        lambda: quant.quantize_rows(x, width),
        lambda: quant.quantize_rows_plain(x, width), None,
        bound(qbytes, 4 * rows * width, FP32_OPS_PER_S)))
    got = quant.dequantize_rows(qc, sc, width, torch.bfloat16)
    want = quant.dequantize_rows_plain(qc, sc, width, torch.bfloat16)
    assert torch.equal(got, want)
    entries.append(entry(
        "dequantize_int8", f"{at}: q[{rows},1,{width}] int8 -> bf16",
        got, want, "bit for bit",
        lambda: quant.dequantize_rows(qc, sc, width, torch.bfloat16),
        lambda: quant.dequantize_rows_plain(qc, sc, width, torch.bfloat16),
        None, bound(qbytes, rows * width, FP32_OPS_PER_S)))
    del x, qc, sc, qp, sp, got, want
    lat = MLA_DECODE_CFG["kv_lora_rank"]
    Lm = lat + MLA_DECODE_CFG["qk_rope_head_dim"]
    heads = MLA_DECODE_CFG["num_heads"] // TP_WORLD
    qm = _randn(gen, MLA_BATCH, heads, Lm)
    cache = _latent_cache(gen, MLA_DECODE_CFG["max_decode_length"],
                          MLA_BATCH, Lm, MLA_DECODE_LENGTH)
    scale = (MLA_DECODE_CFG["qk_nope_head_dim"]
             + MLA_DECODE_CFG["qk_rope_head_dim"]) ** -0.5
    entries.append(_mla_entry(at, qm, cache, MLA_DECODE_LENGTH, lat, scale))
    return entries


_TP_ENTRIES = []  # the tp_serve phase's kernel rows, for the JSON line


def phase_tp_serve():
    import tempfile

    from apex_tpu_torch.models import (
        DeepseekModel,
        GPTModel,
        MLAConfig,
        TransformerConfig,
    )
    cfg = TransformerConfig(**MODEL, compute_dtype=torch.bfloat16)
    vocab = cfg.vocab_size
    # tp = 1 on the same host-drawn weights: the references
    t0 = time.perf_counter()
    model = _host_drawn(lambda dev: GPTModel(cfg, device=dev))
    log(f"tp_serve: tp 1 reference model drawn on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = _tp_prompt(vocab)
    ref, ref_logits, ref_ms = _tp_greedy(model, prompt, NEW_TOKENS)
    log(f"tp_serve: tp 1 decode step {_spread(ref_ms)} = "
        f"{BATCH / statistics.median(ref_ms) * 1e3:.1f} tokens/s")
    ref_engine, _ = _eager_engine(model, _serve_config(
        cache_mode="bf16")).serve(_serve_trace(vocab))
    ref_streams = _streams(ref_engine)
    mcfg = MLAConfig(**MLA_DECODE_CFG, params_dtype=torch.float32,
                     compute_dtype=torch.bfloat16)
    mla = _host_drawn(lambda dev: DeepseekModel(mcfg, device=dev))
    mla_ref, mla_ref_logits = _greedy(mla, _mla_prompt(mcfg.vocab_size),
                                      MLA_STEPS + 2)
    _, cache = mla.decode_prefill(_mla_prompt(mcfg.vocab_size))
    _, _, mla_ms = _greedy_steps(mla, cache, mla_ref[:, 0], MLA_STEPS)
    log(f"tp_serve: tp 1 mla_decode step {_spread(mla_ms)}")
    del mla, cache
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        codes, logs = _launch_ranks("nccl-probe", out, TP_PROBE_TIMEOUT_S)
        for r, text in enumerate(logs):
            lines = [x for x in text.splitlines() if "nccl probe" in x]
            log(f"tp_serve: NCCL with two ranks on one card, rank {r} "
                f"(exit {None if codes is None else codes[r]}): "
                f"{lines or text[-600:]}")
        t0 = time.perf_counter()
        codes, logs = _launch_ranks("tp-worker", out, TP_WORKER_TIMEOUT_S)
        for r, text in enumerate(logs):
            for line in text.splitlines():
                log(f"[rank {r}] {line}")
        assert codes == [0] * TP_WORLD, (
            f"tp_serve workers failed or timed out: exit codes {codes}")
        log(f"tp_serve: both ranks done in {time.perf_counter() - t0:.1f} s")
        res = [torch.load(os.path.join(out, f"rank{r}.pt"))
               for r in range(TP_WORLD)]
    a, b = res
    for key in ("generate", "beam", "mla"):
        assert torch.equal(a[key], b[key]), f"tp_serve: ranks differ: {key}"
    for key in ("serve_bf16", "serve_int8", "serve_spec_prefix"):
        assert a[key] == b[key], f"tp_serve: ranks' {key} streams differ"
    assert a["launches"] == b["launches"]
    log("tp_serve: both ranks' tokens, beams, streams and launch counts "
        "identical")
    _hold_logits("tp_serve prefill, tp 2 vs tp 1", a["generate_logits"][0],
                 ref_logits[0].cpu())
    _hold_logits("tp_serve step 1, tp 2 vs tp 1", a["generate_logits"][1],
                 ref_logits[1].cpu())
    _near_tie_check("tp_serve generate, tp 2 vs tp 1",
                    a["generate"][:, PROMPT:], a["generate_logits"],
                    ref.cpu(), ref_logits.cpu(), LOGIT_TOL)
    _margin_check("tp_serve bf16 engine, tp 2 vs tp 1", model,
                  _serve_trace(vocab), a["serve_bf16"], ref_streams)
    _near_tie_check("tp_serve mla_decode, tp 2 vs tp 1", a["mla"],
                    a["mla_logits"], mla_ref.cpu(), mla_ref_logits.cpu(),
                    LOGIT_TOL)
    del model, ref_logits, mla_ref_logits
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _TP_ENTRIES.extend(_tp_kernel_entries(gen))
    for e in _TP_ENTRIES:
        log(f"tp_serve kernel {e['name']} [{e['shape']}]: max abs err "
            f"{e['max_abs_err']:.3e}; {_us(e['ms'])} on the device, plain "
            f"{_us(e['plain_ms'])}, library {_us(e['library_ms'])}, bound "
            f"{e['bound_ms'] * 1e3:.3f} us by {e['bound_by']}")
    total = {}
    for r in res:
        for counts in r["launches"].values():
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
    log(f"tp_serve: launches of both ranks over every counted run {total}")
    return {"tp_serve": total}


# ---------------------------------------------------------------------------
# telemetry, resilience and checkpoints: K7, resilient_gpt2, serve_guarded,
# guarded_tp_dp
# ---------------------------------------------------------------------------

# K7 against its plain version: counts and absmax exact; the sums of
# squares are fp32 sums of the same non-negative terms in two orders, each
# within (its depth of additions) x 2^-24 of the exact sum, relative: K7's
# depth is 16 + 5 + 8 a chunk and ceil(chunks / 256) + 5 + 8 over the
# chunks (under 60 for GPT-2's largest tensor, 51.5 M elements), torch's
# sum's a few hundred at most; 1e-4 holds both with room, and a dropped or
# doubled chunk moves the sum by a chunk's share (and its counts, exactly)
STATS_SUMSQ_RTOL = 1e-4
# the ragged list: sizes around K7's 4096-element batch and 65536-element
# chunk, the dtypes K7 takes, views at 1-7 element offsets into flat
# buffers, more than one launch's 64 tensors, groups that span the
# launch boundary
STATS_RAGGED_SIZES = (1, 3, 4095, 4097, 65535, 65536, 65537, 131073)
STATS_RAGGED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
STATS_FAULTS = (("each tensor's last chunk's non-finite count dropped", 1),
                ("each tensor's first chunk counted twice", 2))


def _stats_plant(ts):
    """Zeros in each tensor's first chunk, a NaN in the last chunk of
    every third, an inf in every fifth, and fp16/bf16 range values."""
    for k, t in enumerate(ts):
        flat = t.view(-1)
        n = flat.numel()
        flat[:min(n, 7)] = 0
        if n > 16:
            flat[9] = 7e4 if t.dtype != torch.float16 else 6e4
            flat[10] = 1e-6
        if k % 3 == 0:
            flat[-1] = float("nan")
        if k % 5 == 0 and n > 2:
            flat[n // 2] = float("inf")
    return ts


def _stats_gpt2(gen):
    """GPT-2 345M's O2 gradient list (bf16, the norms' fp32) by name,
    grouped by module prefix (depth 3), with planted values."""
    from apex_tpu_torch.telemetry import numerics
    meta = _gpt2_meta()
    names = [n.replace(".", "/") for n, _ in meta.named_parameters()]
    ts = _stats_plant(_like(gen, _o2_shapes(_gpt2_meta), scale=1e-3))
    keys, leaves, ids, ns = numerics.grouping(dict(zip(names, ts)), 3)
    return leaves, ids, len(keys)


def _stats_ragged(gen):
    ts, ids = [], []
    for rep in range(4):
        for s, n in enumerate(STATS_RAGGED_SIZES):
            for d, dt in enumerate(STATS_RAGGED_DTYPES):
                off = 1 + (rep + s + d) % 7
                buf = (torch.randn(n + off, generator=gen, device="cuda")
                       * 10.0 ** (d - 2)).to(dt)
                ts.append(buf[off:])
                ids.append((len(ts) - 1) // 5 % 9)
    return _stats_plant(ts), ids, 9


def _stats_held(label, got, want):
    (gs, gc), (ws, wc) = got, want
    rel = ((gs[:, 0].double() - ws[:, 0].double()).abs()
           / ws[:, 0].double().clamp_min(1e-30)).max().item()
    counts = torch.equal(gc, wc)
    absmax = torch.equal(gs[:, 1], ws[:, 1])
    log(f"multi_tensor_stats {label}: counts {'equal' if counts else 'DIFFER'}"
        f", absmax {'equal' if absmax else 'DIFFERS'}, sums of squares "
        f"within {rel:.3e} relative (limit {STATS_SUMSQ_RTOL})")
    return counts and absmax and rel <= STATS_SUMSQ_RTOL


def check_stats(gen):
    """K7 against its plain version on GPT-2 345M's gradient list and on
    the ragged, unaligned list: counts and absmax exact, sums of squares
    within STATS_SUMSQ_RTOL, two runs bit-identical; each planted fault,
    through K7's own C function, read past the same limits."""
    from apex_tpu_torch.kernels import stats as k7
    entries = []
    for label, (ts, ids, G) in (("GPT-2 345M O2 grads", _stats_gpt2(gen)),
                                ("ragged views", _stats_ragged(gen))):
        want = k7.stats_plain(ts, ids, G)
        got = k7.multi_tensor_stats(ts, ids, G)
        again = k7.multi_tensor_stats(ts, ids, G)
        assert _stats_held(label, got, want), label
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        for what, code in STATS_FAULTS:
            sums = torch.zeros((G, 2), dtype=torch.float32, device="cuda")
            counts = torch.zeros((G, 6), dtype=torch.int64, device="cuda")
            k7.launch_stats([t.contiguous() for t in ts], ids, sums, counts,
                            fault=code)
            caught = not _stats_held(f"{label}, planted: {what}",
                                     (sums, counts), want)
            log(f"multi_tensor_stats {label}: planted fault ({what}) "
                f"{'caught' if caught else 'NOT caught'}")
            assert caught, what
        n = sum(t.numel() for t in ts)
        nbytes = sum(t.numel() * t.element_size() for t in ts)
        log(f"multi_tensor_stats {label}: {len(ts)} tensors, {n} elements "
            f"({nbytes / 1e9:.3f} GB), {G} groups; two runs bit-identical")
        if label.startswith("GPT-2"):
            entries.append(dict(entry(
                "multi_tensor_stats", f"{len(ts)} tensors, {n} elements",
                got[0][:, 0], want[0][:, 0],
                f"counts, absmax exact; sumsq rtol {STATS_SUMSQ_RTOL}",
                lambda: k7.multi_tensor_stats(ts, ids, G),
                lambda: k7.stats_plain(ts, ids, G),
                lambda: torch._foreach_norm(ts),
                bound(nbytes, 2 * n, FP32_OPS_PER_S)),
                library="torch._foreach_norm, the l2 norm of each tensor: "
                        "one of K7's eight fields"))
    return entries


# resilient_gpt2: GPT-2 345M (bench_gpt2's 8 x 1024, flash), amp O2 with
# FusedAdam on fp32 masters, under the Supervisor with guarded_update, a
# flight recorder, the registry's JSONL sink and an AsyncCheckpointer. The
# faults, each once, by the step it fires at (the lineage's step number):
RESILIENT_STEPS = 10                 # the supervised run's last step + 1
RESILIENT_SNAPSHOT_EVERY, RESILIENT_CKPT_EVERY = 2, 4
RESILIENT_NAN_STEP = 1               # one module's gradients poisoned
RESILIENT_NAN_PREFIX = "transformer/layers/5/mlp"
RESILIENT_STREAK = (3, 4, 5)         # three in a row: check_guard escalates
RESILIENT_ALLOC_STEP = 6             # a synthetic RESOURCE_EXHAUSTED
RESILIENT_OOM_STEP = 7               # a real CUDA out-of-memory
RESILIENT_TORN_STEP = 8              # the checkpoint written entering it tears
RESILIENT_PREEMPT_STEP = 9           # a real SIGTERM during this step
RESILIENT_RESUME_STEPS = 2           # the resumed and unkilled runs' steps
RESILIENT_TIMED = 3                  # steps timed with telemetry off / on
RECORDER_DEPTH = 3                   # the recorder's groups: transformer/layers/k
FLOPS_CLOSED_FORM_RTOL = 0.10


def _fingerprint(tensors):
    """A hash of the tensors' bits: per tensor the sum of its bit
    patterns and their sum weighted by position (int64 on the card, one
    copy to the host for all of them), hashed with sha256."""
    import hashlib
    parts = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        bits = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()]).long()
        w = torch.arange(1, bits.numel() + 1, device=bits.device,
                         dtype=torch.int64) % 1000003
        parts.append(torch.stack([bits.sum(), (bits * w).sum()]))
    host = torch.stack(parts).cpu().numpy().tobytes()
    return hashlib.sha256(host).hexdigest()[:16]


class _ResilientRun:
    """The model, the amp optimizer, the guard and the recorder of the
    phase, and its supervised step."""

    def __init__(self, label, sink):
        import math

        from apex_tpu_torch import amp
        from apex_tpu_torch.kernels import optim
        from apex_tpu_torch.models import GPTModel, TransformerConfig
        from apex_tpu_torch.optimizers import FusedAdam
        from apex_tpu_torch.resilience import init_guard_state
        from apex_tpu_torch.telemetry import FlightRecorder
        self.label, self.sink = label, sink
        cfg = TransformerConfig(**GPT2, compute_dtype=torch.bfloat16,
                                use_flash_attention=True)
        self.cfg = cfg
        self.model = _new_model(label, lambda: GPTModel(cfg))
        self.model, self.opt = amp.initialize(
            self.model, FusedAdam(self.model.parameters(), lr=GPT2_LR),
            opt_level="O2", verbosity=0)
        self.params = list(self.model.parameters())
        # the optimizer's state made now (a step makes it at its first),
        # so the supervisor's state is whole from step 0
        with torch.no_grad():
            for g in self.opt.param_groups:
                g["step"] = torch.zeros(1, dtype=torch.int32, device="cuda")
            for p in self.params:
                for name in ("exp_avg", "exp_avg_sq"):
                    self.opt.state[p].setdefault(
                        name, torch.zeros_like(p, dtype=torch.float32))
        self.gst = init_guard_state("cuda")
        self.rec = FlightRecorder(length=8, prefix_depth=RECORDER_DEPTH)
        self.rstate = None
        self.fired = set()
        self.skips = []        # (step, state kept bit for bit, scale ratio)
        self.postmortems = []
        self.ckptr = None
        self.ckpt_dir = os.path.join(sink, "async_ckpt")
        self.saved = {}        # step -> fingerprint of the state saved
        self.ckpt_outcome = None
        L = cfg.num_layers
        self.per_step = {"layer_norm": 2 * L + 1, "ln_bwd": 2 * L + 1,
                         "flash_fwd": L, "flash_dq": L, "flash_dkv": L,
                         "multi_tensor_stats": math.ceil(
                             len(self.params) / optim.MAX_TENSORS)}

    # -- the state the supervisor snapshots, checkpoints and restores --
    def live(self):
        st = self.opt.state
        return {
            "params": [p.data for p in self.params],
            "masters": [st[p]["amp_master"] for p in self.params],
            "exp_avg": [st[p]["exp_avg"] for p in self.params],
            "exp_avg_sq": [st[p]["exp_avg_sq"] for p in self.params],
            "step": [g["step"] for g in self.opt.param_groups],
            "loss_scale": self.opt.scaler._state.loss_scale,
            "unskipped": self.opt.scaler._state.unskipped,
            "guard": list(self.gst)}

    def model_tensors(self):
        """What a skipped step must leave as it was: the parameters, the
        masters, the moments and the device step count."""
        s = self.live()
        return (s["params"] + s["masters"] + s["exp_avg"] + s["exp_avg_sq"]
                + s["step"])

    def tensors(self, state=None):
        s = state or self.live()
        return (s["params"] + s["masters"] + s["exp_avg"] + s["exp_avg_sq"]
                + s["step"] + [s["loss_scale"], s["unskipped"]] + s["guard"])

    def load(self, state):
        """Copy a (host) state into the live tensors."""
        with torch.no_grad():
            for dst, src in zip(self.tensors(), self.tensors(state)):
                dst.copy_(src)

    def batch(self, step):
        """Tokens and labels from a generator seeded by the step number."""
        gen = torch.Generator().manual_seed(SEED + 1000 + step)
        shape = (GPT2_BATCH, GPT2_SEQ)
        tokens = torch.randint(0, self.cfg.vocab_size, shape, generator=gen)
        labels = torch.randint(0, self.cfg.vocab_size, shape, generator=gen)
        return tokens.cuda(), labels.cuda()

    def census_labels(self):
        s = self.live()
        return {"params": s["params"], "masters": s["masters"],
                "moments": s["exp_avg"] + s["exp_avg_sq"]}

    def once(self, kind, step, at):
        hit = (step in at if isinstance(at, tuple) else step == at)
        if hit and (kind, step) not in self.fired:
            self.fired.add((kind, step))
            return True
        return False

    # -- one guarded step ------------------------------------------------
    def train_step(self, step, poison=None):
        from apex_tpu_torch.models import gpt_loss_fn
        from apex_tpu_torch.resilience import faults, guarded_update
        from apex_tpu_torch.telemetry import numerics, span
        tokens, labels = self.batch(step)
        with span("train/fwd_bwd", step=step):
            self.opt.zero_grad()
            loss = gpt_loss_fn(self.model(tokens), labels)
            self.opt.scale_loss(loss).backward()
        _, found_inf = self.opt.unscale()
        grads = numerics.module_grads(self.model)
        if poison is not None:
            with torch.no_grad():
                for name, g in faults.inject_nan(
                        grads, step, nan_step=step,
                        path_filter=poison).items():
                    grads[name].copy_(g)
        if self.rstate is None:
            self.rstate = self.rec.init_state(grads)

        def opt_update(g, state, flag):
            self.opt.apply(flag)
            return state

        with span("train/optimizer", step=step):
            _, self.gst, self.opt.scaler._state, self.rstate = \
                guarded_update(grads, opt_update, {}, self.gst,
                               found_inf=found_inf, scaler=self.opt.scaler,
                               scaler_state=self.opt.scaler._state,
                               recorder=self.rec, recorder_state=self.rstate,
                               step=step)
        return loss

    def step_fn(self, state, step):
        """The supervised step: put a restored state back on the card, the
        periodic async checkpoint, the planted faults (each once), the
        guarded step under guarded_call, and check_guard's poll."""
        from apex_tpu_torch import checkpoint
        from apex_tpu_torch.resilience import (check_guard, faults,
                                               guarded_call)
        if state["params"][0].device.type == "cpu":
            self.load(state)
        # a checkpoint step's first visit writes; a replay after a revert
        # does not write the step again (a 5.69 GB write on the host)
        if step and step % RESILIENT_CKPT_EVERY == 0 and \
                step not in self.saved:
            self.checkpoint(step)
        poison = None
        if self.once("nan", step, RESILIENT_NAN_STEP):
            poison = RESILIENT_NAN_PREFIX
        elif self.once("streak", step, RESILIENT_STREAK):
            poison = ""
        before = _fingerprint(self.model_tensors()) \
            if poison is not None else None
        scale0 = float(self.opt.scaler._state.loss_scale) \
            if poison is not None else None

        def body():
            if self.once("alloc", step, RESILIENT_ALLOC_STEP):
                faults.inject_alloc_failure(step, alloc_step=step)
            if self.once("oom", step, RESILIENT_OOM_STEP):
                # more than the card's free bytes and the allocator's
                # cached ones together: the allocator's retry after
                # freeing its cache fails too
                free, _ = torch.cuda.mem_get_info()
                cached = (torch.cuda.memory_reserved()
                          - torch.cuda.memory_allocated())
                ask = free + cached + 2**30
                log(f"{self.label}: step {step}: allocating "
                    f"{ask / 2**30:.1f} GiB with {free / 2**30:.1f} GiB "
                    f"free and {cached / 2**30:.1f} GiB cached")
                torch.empty(ask, dtype=torch.uint8, device="cuda")
            return self.train_step(step, poison)

        guarded_call(body, oom_dir=self.sink, labels=self.census_labels())
        if poison is not None:
            self.skips.append((step,
                               _fingerprint(self.model_tensors()) == before,
                               float(self.opt.scaler._state.loss_scale)
                               / scale0))
        try:
            check_guard(self.gst, 3, recorder=self.rec,
                        recorder_state=self.rstate,
                        postmortem_dir=self.sink)
        finally:
            if self.rec.last_postmortem is not None and (
                    not self.postmortems or self.postmortems[-1]
                    is not self.rec.last_postmortem):
                self.postmortems.append(self.rec.last_postmortem)
        if self.once("preempt", step, RESILIENT_PREEMPT_STEP):
            faults.simulate_preemption()
        if step == RESILIENT_TORN_STEP and self.ckpt_outcome and \
                "settled" not in self.ckpt_outcome:
            self.torn_outcome(checkpoint)
        return self.live()

    def checkpoint(self, step):
        """The periodic async checkpoint of the state entering ``step``:
        the previous write waited for (and its bytes and seconds logged)
        first; the one at RESILIENT_TORN_STEP torn, and waited for inside
        the fault's scope."""
        from apex_tpu_torch import checkpoint
        from apex_tpu_torch.resilience import faults
        if self.ckptr is None:
            self.ckptr = checkpoint.AsyncCheckpointer(keep_last_n=2)
        self.finish_write()
        self.saved[step] = _fingerprint(self.tensors())
        state = {"state": self.live(), "step": step}
        t0 = time.perf_counter()
        if step == RESILIENT_TORN_STEP and not self.ckpt_outcome:
            with faults.torn_checkpoint_write():
                self.ckptr.save(self.ckpt_dir, step, state)
                try:
                    self.ckptr.wait_until_finished()
                    self.ckpt_outcome = {"torn_detected_at_write": False}
                except checkpoint.CheckpointCorruptError as e:
                    self.ckpt_outcome = {
                        "torn_detected_at_write": str(e)[:120]}
            return
        self.ckptr.save(self.ckpt_dir, step, state)
        self.pending_write = (step, time.perf_counter() - t0)

    def finish_write(self):
        """Wait for the in-flight async write and log it."""
        if getattr(self, "pending_write", None) is None:
            return
        step, queue_s = self.pending_write
        self.pending_write = None
        self.ckptr.wait_until_finished()
        nbytes, secs = self.ckptr.last_bytes, self.ckptr.last_write_seconds
        self.ckpt_stats = (nbytes, secs)
        log(f"{self.label}: async checkpoint of step {step}: "
            f"{nbytes / 1e9:.3f} GB written in {secs:.2f} s "
            f"({nbytes / 1e9 / secs:.2f} GB/s: pickle, the manifest's "
            f"crc32s and sha256, the verify before pruning); the step "
            f"held {queue_s * 1e3:.1f} ms to queue the copy to pinned "
            f"memory")

    def torn_outcome(self, checkpoint):
        """The torn step-8 write: restore() walks back to the last
        verified step, whose state is the one saved there."""
        import warnings
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            payload, meta = checkpoint.restore(self.ckpt_dir,
                                               with_metadata=True)
        restored = _fingerprint([t.cuda() for t in self.tensors(
            payload["state"])])
        self.ckpt_outcome.update(
            settled=meta["settled_step"],
            rejected=[r["step"] for r in meta["rejected"]],
            restore_s=time.perf_counter() - t0,
            equal=restored == self.saved.get(meta["settled_step"]),
            warned=any("REJECTED" in str(w.message) for w in caught))
        del payload


def phase_resilient_gpt2():
    """GPT-2 345M amp O2 under the Supervisor, every fault planted once:
    a poisoned module (skipped bit for bit, scale halved, post-mortem
    naming it), three poisoned steps in a row (escalation, hot-snapshot
    revert, scale backoff, ledger verified), a synthetic and a real OOM
    (memory post-mortems whose census names the masters and moments), a
    torn checkpoint (restore walks back to the last verified step), a
    real SIGTERM (one final save, clean exit; the resumed run's state
    equal to the unkilled run's). Then the step with telemetry off and
    on, and step_cost's FLOPs against the closed form."""
    import json as _json
    import shutil

    from apex_tpu_torch import amp, telemetry
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.resilience import (PreemptionGuard, Supervisor,
                                           faults)
    from apex_tpu_torch.telemetry import cost
    label = "resilient_gpt2"
    t_phase = time.perf_counter()
    sink = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "resilient_gpt2")
    shutil.rmtree(sink, ignore_errors=True)
    os.makedirs(sink)
    run = _ResilientRun(label, sink)
    reg = telemetry.MetricsRegistry(jsonl_dir=sink)
    final_dir = os.path.join(sink, "final_ckpt")

    def sup_for(step_fn, state, guard=None, start=0):
        return Supervisor(
            step_fn, state, snapshot_every=RESILIENT_SNAPSHOT_EVERY,
            checkpoint_dir=final_dir, keep_last_n=1, preemption_guard=guard,
            snapshot_ok=lambda st: int(st["guard"][0]) == 0,
            registry=reg, start_step=start, sleep=lambda s: None)

    registry.reset()
    t0 = time.perf_counter()
    with telemetry.use_registry(reg), PreemptionGuard() as guard:
        sup = sup_for(run.step_fn, run.live(), guard)
        report = sup.run(RESILIENT_STEPS + 5)
        run.finish_write()
    launches = registry.launches()
    run_s = time.perf_counter() - t0
    exit_fp = _fingerprint(run.tensors())
    log(f"{label}: supervised run {run_s:.1f} s: exit {report['exit']!r} at "
        f"step {report['final_step']}, {report['dispatches']} dispatches, "
        f"restarts {report['restarts']} {report['causes']}, snapshot "
        f"restores {report['snapshot_restores']}, steps lost "
        f"{report['steps_lost']}, MTTR {report['mttr_steps']} steps, goodput "
        f"{report['goodput_step_ratio']:.3f}; ledger {report['ledger']}")
    log(f"{label}: launches of the run {launches}")
    # 1. the one poisoned module
    nan = [s for s in run.skips if s[0] == RESILIENT_NAN_STEP]
    first = run.postmortems[0]
    log(f"{label}: NaN gradients in {RESILIENT_NAN_PREFIX} at step "
        f"{RESILIENT_NAN_STEP}: skipped with the state hash-equal "
        f"{nan[0][1]}, loss scale x{nan[0][2]}; post-mortem names "
        f"{first['first_nonfinite_prefix']!r} at step "
        f"{first['first_nonfinite_step']} ({first['path']})")
    assert nan and nan[0][1] and nan[0][2] == 0.5, run.skips
    assert RESILIENT_NAN_PREFIX.startswith(first["first_nonfinite_prefix"])
    assert first["first_nonfinite_step"] == RESILIENT_NAN_STEP
    # 2. the streak: escalation, snapshot revert with backoff
    streak = [s for s in run.skips if s[0] in RESILIENT_STREAK]
    log(f"{label}: poisoned steps {RESILIENT_STREAK}: skips {streak}; "
        f"escalation post-mortem {run.postmortems[-1]['reason']!r}")
    assert all(s[1] for s in streak), streak
    assert report["causes"].get("numerics") == 1, report
    assert report["ledger"]["monotonic"]
    # 3. the OOMs
    mem = [json_load(os.path.join(sink, "memory-postmortem-rank0.json"))]
    labels = {g["label"] for g in mem[0]["census"]["groups"]}
    log(f"{label}: OOM class {report['causes'].get('oom')} times (a "
        f"synthetic RESOURCE_EXHAUSTED at step {RESILIENT_ALLOC_STEP}, a real "
        f"CUDA OOM at step {RESILIENT_OOM_STEP}); the last memory "
        f"post-mortem's census labels {sorted(labels)}, "
        f"{mem[0]['census']['total_bytes'] / 2**30:.2f} GiB live; error "
        f"{mem[0]['error'][:80]!r}")
    assert report["causes"].get("oom") == 2, report
    assert {"masters", "moments"} <= labels, labels
    assert "OutOfMemoryError" in mem[0]["error"], mem[0]["error"]
    # 4. the torn checkpoint
    co = run.ckpt_outcome
    log(f"{label}: torn checkpoint at step {RESILIENT_TORN_STEP}: {co}")
    assert co and co["settled"] == RESILIENT_TORN_STEP - RESILIENT_CKPT_EVERY
    assert co["rejected"] == [RESILIENT_TORN_STEP] and co["equal"], co
    nbytes, write_s = run.ckpt_stats
    # 5. the SIGTERM: one final save, a clean exit, the resume
    assert report["exit"] == "preempted", report
    assert report["final_step"] == RESILIENT_PREEMPT_STEP + 1, report
    log(f"{label}: SIGTERM during step {RESILIENT_PREEMPT_STEP}: final "
        f"checkpoint at step {report['final_step']}; handlers restored "
        f"{signal_default()}")
    resumed = _ResilientResume(run, sup_for, exit_fp, reg)
    log(f"{label}: {resumed}")
    assert resumed.restored_equal, resumed
    # telemetry off / on, step_cost and the closed form
    times = {}
    for name, r in (("off", telemetry.MetricsRegistry()), ("on", reg)):
        with telemetry.use_registry(r):
            ms = []
            for k in range(RESILIENT_TIMED):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run.train_step(RESILIENT_STEPS + 10 + k)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            times[name] = statistics.median(ms)
    log(f"{label}: guarded step (flight recorder and K7 included) "
        f"{times['off']:.2f} ms with telemetry off, {times['on']:.2f} ms "
        f"with it on (median of {RESILIENT_TIMED}, host clock, synchronized)")
    with telemetry.use_registry(telemetry.MetricsRegistry()):
        c = cost.step_cost(run.train_step, RESILIENT_STEPS + 20)
    closed = _gpt2_closed_form_flops(run.model)
    util = cost.utilization(c["flops"], times["off"] / 1e3)
    log(f"{label}: step_cost {c['flops']:.4e} FLOPs ({c['torch_flops']:.4e} "
        f"counted by FlopCounterMode, {c['kernel_flops']:.4e} by the port's "
        f"kernels: {sorted(c['by_kernel'])}); closed form 6 N T + attention "
        f"with flash's recompute {closed:.4e}; ratio "
        f"{c['flops'] / closed:.4f}; MFU {util['mfu']:.4f} of "
        f"{cost.peak_table()[0] / 1e12:.0f} TFLOP/s bf16")
    assert abs(c["flops"] / closed - 1) <= FLOPS_CLOSED_FORM_RTOL, (c, closed)
    assert 0 < util["mfu"] <= 1, util
    log(f"{label}: checkpoint {nbytes / 1e9:.3f} GB, written in "
        f"{write_s:.2f} s ({nbytes / 1e9 / write_s:.2f} GB/s)")
    reg.flush()
    reg.disable()
    _json.loads(open(os.path.join(sink, "telemetry-rank0.jsonl")
                     ).readline())
    amp.initialize(run.model, None, enabled=False)
    faults.disarm_slot_nan()
    del run, resumed
    shutil.rmtree(sink, ignore_errors=True)
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s")
    return {label: launches}


def json_load(path):
    with open(path) as f:
        return json.load(f)


def signal_default():
    import signal
    return signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def _gpt2_closed_form_flops(model):
    """6 N T (N the matmul weights: every 2-D parameter but the token and
    position tables) plus the attention's with flash's recompute: per
    layer and head, pairs = s (s + 1) / 2 causal query-key pairs times
    d, 4 FLOPs a unit in the forward, 6 in the dq kernel and 8 in the
    dk/dv kernel."""
    cfg = model.config
    n = sum(p.numel() for name, p in model.named_parameters()
            if p.dim() == 2 and "embeddings" not in name)
    T = GPT2_BATCH * GPT2_SEQ
    d = cfg.hidden_size // cfg.num_attention_heads
    pairs = GPT2_SEQ * (GPT2_SEQ + 1) // 2
    attn = 18 * GPT2_BATCH * cfg.num_attention_heads * pairs * d
    return 6 * n * T + cfg.num_layers * attn


class _ResilientResume:
    """The preempted run's final checkpoint, restored by a new supervisor
    into the same live tensors (first overwritten with zeros to show the
    load), must equal the unkilled state at that step; then the resumed
    and the unkilled runs each take RESILIENT_RESUME_STEPS more steps
    from it, and their states are compared (equal where the step is
    deterministic on the card)."""

    def __init__(self, run, sup_for, exit_fp, reg):
        from apex_tpu_torch import telemetry
        from apex_tpu_torch.resilience.supervisor import host_copy
        step0 = RESILIENT_PREEMPT_STEP + 1
        end = step0 + RESILIENT_RESUME_STEPS
        unkilled_state = host_copy(run.live())
        with telemetry.use_registry(reg):
            sup = sup_for(run.step_fn, run.live(), start=step0)
            sup.run(end)
        self.unkilled = _fingerprint(run.tensors())
        with torch.no_grad():
            for t in run.tensors():
                t.zero_()
        t0 = time.perf_counter()
        with telemetry.use_registry(reg):
            sup2 = sup_for(run.step_fn, run.live())
            meta = sup2.restore_from_checkpoint()
        self.restore_s = time.perf_counter() - t0
        run.load(sup2.state)
        self.settled = meta["settled_step"]
        self.restored = _fingerprint(run.tensors())
        self.restored_equal = self.restored == exit_fp and \
            self.settled == step0 and _fingerprint(
                [t.cuda() for t in run.tensors(unkilled_state)]) == exit_fp
        with telemetry.use_registry(reg):
            sup2.run(end)
        self.resumed = _fingerprint(run.tensors())

    def __repr__(self):
        return (f"resume from the final checkpoint (step {self.settled}, "
                f"restored in {self.restore_s:.2f} s): state hash "
                f"{self.restored} {'equal to' if self.restored_equal else 'DIFFERENT from'}"
                f" the unkilled run's at that step; after "
                f"{RESILIENT_RESUME_STEPS} more steps each, resumed "
                f"{self.resumed} and unkilled {self.unkilled} "
                f"({'equal' if self.resumed == self.unkilled else 'different: the step is not bit-deterministic on the card'})")


# serve_guarded: the TinyLlama-1.1B engine (bf16, its CUDA graphs) with
# telemetry on and preflight=True; a decode failure at a call, retried
# once, and one active slot poisoned at a later call
SERVE_FAIL_AT, SERVE_POISON_AT = 3, 6   # decode calls into the traffic
SERVE_PREEMPT_AFTER = 4                 # scheduler steps before SIGTERM


def phase_serve_guarded():
    import dataclasses
    import shutil

    from apex_tpu_torch import telemetry
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.resilience import PreemptionGuard, faults
    from apex_tpu_torch.serving import RobustConfig, Scheduler, ServeEngine
    from apex_tpu_torch.telemetry import compile_watch
    from apex_tpu_torch.telemetry.memory import MemoryBudgetError
    label = "serve_guarded"
    t_phase = time.perf_counter()
    sink = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "serve_guarded")
    shutil.rmtree(sink, ignore_errors=True)
    model = _serve_model()
    L, vocab = model.num_layers, model.config.vocab_size
    reg = telemetry.MetricsRegistry(jsonl_dir=sink)
    events = []
    reg.add_event_tap(events.append)
    with telemetry.use_registry(reg):
        engine = ServeEngine(model, _serve_config(cache_mode="bf16",
                                                  preflight=True),
                             registry=reg)
    size = _ladder_report(label, engine)
    rep = engine.memory_report
    log(f"{label}: preflight: decode peak {rep['peak_bytes'] / 2**30:.3f} "
        f"GiB = weights {engine.weight_bytes() / 2**30:.3f} + store "
        f"{engine.kv_cache_bytes() / 2**30:.3f} + graph pool "
        f"{engine.graph_pool_bytes / 2**30:.3f}, capacity "
        f"{rep['capacity_bytes'] / 2**30:.2f} GiB, headroom "
        f"{rep['headroom_frac']:.4f}")
    engine.serve(_serve_trace(vocab, n=4, seed=0))  # warm
    trace = _serve_trace(vocab)
    robust = RobustConfig(decode_retries=1, retry_backoff_s=0.0)
    registry.reset()
    t0 = time.perf_counter()
    with telemetry.use_registry(reg), \
            compile_watch.assert_no_recompiles() as watcher:
        sched = Scheduler(engine, robust=robust, registry=reg)
        for r in trace:
            sched.submit(r)
        base = engine._decode_calls
        fail = faults.arm_decode_failure(base + SERVE_FAIL_AT, True)
        poisoned = None
        while sched.pending or sched.active:
            if poisoned is None and \
                    engine._decode_calls >= base + SERVE_POISON_AT \
                    and sched.active:
                poisoned = faults.arm_slot_nan(min(sched.active),
                                               engine._decode_calls)
            if not sched.active and sched.pending and min(
                    r.arrival for r in sched.pending) > sched.tick:
                sched.tick = min(r.arrival for r in sched.pending)
            sched.step()
        done = sched.completed
    wall = time.perf_counter() - t0
    faults.disarm_decode_failure()
    faults.disarm_slot_nan()
    launches = registry.launches()
    steps, calls = sched.decode_steps, sched.prefill_calls
    reasons = sorted(c.finish_reason for c in done)
    log(f"{label}: {len(done)} requests in {wall:.2f} s under "
        f"assert_no_recompiles (compile_count {engine.compile_count}, "
        f"flat); decode failure fired {fail['fired']} time(s), retried "
        f"({engine.decode_retries_total} retries); slot "
        f"{poisoned['slot'] if poisoned else None} poisoned at call "
        f"{poisoned['step'] if poisoned else None} (fired "
        f"{poisoned['fired'] if poisoned else 0}); finish reasons {reasons}")
    assert fail["fired"] == 1 and engine.decode_retries_total == 1
    assert poisoned and poisoned["fired"] == 1
    assert reasons.count("poisoned") == 1 and len(done) == len(trace)
    assert set(reasons) <= {"length", "poisoned"}, reasons
    assert engine.compile_count == size
    _expect(label, launches, {
        "rms_norm": (2 * L + 1) * (steps + calls),
        "gqa_decode": L * steps, "window_attention": L * calls})
    spans = {}
    for e in events:
        if e["kind"] == "span" and e["name"].startswith("serve/"):
            spans.setdefault(e.get("rid"), set()).add(e["name"])
    traced = [c.rid for c in done if {"serve/request", "serve/prefill",
                                      "serve/evict"} <= spans.get(c.rid,
                                                                  set())]
    ids = {e.get("trace_id") for e in events
           if e["name"] == "request_done"}
    log(f"{label}: {len(traced)} of {len(done)} requests traced (root, "
        f"prefill, decode, evict spans), {len(ids - {None})} trace ids; "
        f"{sum(e['kind'] == 'span' for e in events)} span events")
    assert len(traced) == len(done) and None not in ids
    # the strict preflight under the measured need (the capacity through
    # $APEX_TPU_HBM_GB, decimal GB)
    need = rep["peak_bytes"]
    cfg = engine.config
    engine.config = dataclasses.replace(cfg, preflight_strict=True)
    os.environ["APEX_TPU_HBM_GB"] = str((need - 1000) / 1e9)
    try:
        engine._preflight()
        refused = False
    except MemoryBudgetError as e:
        refused = str(e)[:100]
    finally:
        del os.environ["APEX_TPU_HBM_GB"]
    engine.config = cfg
    log(f"{label}: preflight_strict at {need - 1000} bytes: refused "
        f"{refused!r}")
    assert refused
    # tokens/s with telemetry off and on, in this call
    tps = {}
    for name, r in (("off", telemetry.MetricsRegistry()),
                    ("on", reg), ("off again", telemetry.MetricsRegistry())):
        with telemetry.use_registry(r):
            _, stats = engine.serve(_serve_trace(vocab))
        tps[name] = stats["tokens_per_sec"]
    log(f"{label}: tokens/s with telemetry off {tps['off']:.1f}, on "
        f"{tps['on']:.1f}, off again {tps['off again']:.1f} (same trace, "
        f"same engine, this call)")
    # SIGTERM mid-traffic drains a second engine's scheduler
    del engine
    torch.cuda.empty_cache()
    with telemetry.use_registry(reg):
        engine = ServeEngine(model, _serve_config(cache_mode="bf16"),
                             registry=reg)
    with telemetry.use_registry(reg), PreemptionGuard() as guard:
        drain = Scheduler(engine, guard=guard, registry=reg)
        for r in _serve_trace(vocab):
            drain.submit(r)
        for _ in range(SERVE_PREEMPT_AFTER):
            drain.step()
        active = len(drain.active)
        faults.simulate_preemption()
        drain.step()
        moved = drain.extract_unfinished(reason="preempted",
                                         which="pending")
        finished = drain.run()
    log(f"{label}: SIGTERM after {SERVE_PREEMPT_AFTER} steps ({active} "
        f"active): draining {drain.draining} ({drain._drain_reason}); "
        f"{len(moved)} pending requests extracted, "
        f"{len(finished)} finished in the drain "
        f"{sorted({c.finish_reason for c in finished})}; report "
        f"{drain.drain_report}")
    assert drain.draining and drain._drain_reason == "preempted"
    assert moved and len(moved) + len(finished) == SERVE_REQUESTS
    reg.flush()
    reg.disable()
    shutil.rmtree(sink, ignore_errors=True)
    del engine
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s")
    return {label: launches}


GUARD_NAN_STEP, GUARDED_STEPS = 1, 3


def phase_guarded_tp_dp():
    """mesh2d's guarded step at tp_dp's shapes on a 1 x 1 mesh (one-rank
    NCCL group), fused (#20), the int8 sync, NaN planted at step
    GUARD_NAN_STEP: that step leaves the shards and the residual bit for
    bit, the steps around it commit."""
    from apex_tpu_torch.kernels import registry
    from apex_tpu_torch.parallel import mesh2d
    from apex_tpu_torch.parallel.distributed import _leaves
    label = "guarded_tp_dp"
    t_phase = time.perf_counter()
    m = TP_DP_MODEL
    with tp_mesh() as mesh:
        seg = mesh2d.gpt2_init(**m)
        batch = mesh2d.make_batch(mesh, batch_per_replica=TP_DP_BATCH,
                                  seq=m["max_seq"], vocab=m["vocab"])
        step, (sp, res, gst) = mesh2d.build_train_step(
            mesh, seg, hidden=m["hidden"], heads=m["heads"], mode="guarded",
            fused=True, guard_nan_step=GUARD_NAN_STEP)
        registry.reset()
        outcome = []
        for k in range(GUARDED_STEPS):
            before = [t.clone() for t in _leaves(sp) + _leaves(res)]
            sp, res, gst, loss = step(sp, res, gst, k, *batch)
            same = all(torch.equal(a, b) for a, b in
                       zip(before, _leaves(sp) + _leaves(res)))
            outcome.append((k, same, [int(v) for v in gst],
                            float(loss)))
        launches = registry.launches()
    log(f"{label}: {m}, batch {TP_DP_BATCH} x {m['max_seq']}, fused, int8 "
        f"sync: (step, state bit-identical, guard [streak, total, last], "
        f"loss) {outcome}; launches {launches}")
    assert [o[1] for o in outcome] == [k == GUARD_NAN_STEP
                                       for k in range(GUARDED_STEPS)]
    assert outcome[-1][2] == [0, 1, 0]
    assert launches["tp_matmul"] > 0
    log(f"{label}: phase {time.perf_counter() - t_phase:.1f} s")
    return {label: launches}


PROFILE_WATCH = ("ln_fwd_kernel", "warp_ln_fwd", "ln_bwd_dx",
                 "warp_softmax_fwd", "warp_causal_fwd", "causal_fwd_kernel",
                 "::bwd_kernel<", "warp_softmax_bwd",
                 "lamb_kernel", "adam_kernel", "adam_vec_kernel",
                 "::fwd_kernel<", "::mma_fwd_kernel<", "::bf16_fwd_kernel<",
                 "::mma_dq_kernel<",
                 "::mma_dkv_kernel<", "::dq_kernel<", "::dkv_kernel<",
                 "rms_", "mma_mla_decode", "dequant_vec_kernel",
                 "::quant_vec_kernel<", "::quant_kernel<", "Int8KV<",
                 "scale_kernel<", "sgd_kernel<", "lamb_stage2_kernel<",
                 "scale_vec_kernel<", "sgd_vec_kernel<",
                 "adagrad_vec_kernel<", "novograd_norm_kernel<",
                 "novograd_update_kernel<")
PHASES = ("kernels", "serving", "serve_bf16", "serve_int8", "serve_spec",
          "serve_prefix", "training", "flash_training", "gpt2_training",
          "bert_training", "mha", "mla_decode", "deepseek_v2_lite", "ddp_gpt2",
          "ddp_compressed", "zero_gpt2", "zero_bert", "tp_dp", "tp_gpt2",
          "amp_gpt2", "amp_o1_sgd", "amp_bert", "novograd_gpt2",
          "adagrad_gpt2", "fp16_gpt2", "tp_serve", "resilient_gpt2",
          "serve_guarded", "guarded_tp_dp")
# kernels that no path of this script launches: held against their plain
# versions in the kernel phase only (the JAX serving engine does not take
# the fused int8 verify either: it dequantizes with #15, then verifies;
# no JAX library path dequantizes int4 codes with #17: the int4 sum is
# int32 and goes through #15; the int4 gather takes the fused #23/#24 by
# default, and #18/#19 (with #16 and #15) only with its fused_cc gate off;
# LAMB's stage 1 with a decay a tensor is the public two-stage op's route,
# which no JAX library path takes)
KERNEL_PHASE_ONLY = ("spec_verify", "dequantize_int4", "pack_int4",
                     "unpack_int4", "lamb_stage1_decay")
SOURCES = {  # kernel -> (its source, the TPU kernel it replaces)
    "rms_norm": ("apex_tpu_torch/csrc/rms_norm.cu",
                 "apex_tpu/kernels/norm.py:85"),
    "rms_bwd": ("apex_tpu_torch/csrc/rms_norm.cu",
                "apex_tpu/kernels/norm.py:94"),
    "window_attention": ("apex_tpu_torch/csrc/window_attention.cu",
                         "apex_tpu/kernels/fused_cc.py:313"),
    "gqa_decode": ("apex_tpu_torch/csrc/gqa_decode.cu",
                   "apex_tpu/contrib/gqa_decode.py:66"),
    "causal_softmax": ("apex_tpu_torch/csrc/softmax.cu",
                       "apex_tpu/kernels/softmax.py:79"),
    "softmax_bwd": ("apex_tpu_torch/csrc/softmax.cu",
                    "apex_tpu/kernels/softmax.py:95"),
    "adam": ("apex_tpu_torch/csrc/adam.cu", "apex_tpu/kernels/optim.py:90"),
    "flash_fwd": ("apex_tpu_torch/csrc/flash_attention.cu",
                  "apex_tpu/contrib/fmha.py:103"),
    "flash_dq": ("apex_tpu_torch/csrc/flash_attention.cu",
                 "apex_tpu/contrib/fmha.py:237"),
    "flash_dkv": ("apex_tpu_torch/csrc/flash_attention.cu",
                  "apex_tpu/contrib/fmha.py:278"),
    "layer_norm": ("apex_tpu_torch/csrc/layer_norm.cu",
                   "apex_tpu/kernels/norm.py:63"),
    "ln_bwd": ("apex_tpu_torch/csrc/layer_norm.cu",
               "apex_tpu/kernels/norm.py:72"),
    "scaled_softmax": ("apex_tpu_torch/csrc/softmax.cu",
                       "apex_tpu/kernels/softmax.py:62"),
    "masked_softmax": ("apex_tpu_torch/csrc/softmax.cu",
                       "apex_tpu/kernels/softmax.py:69"),
    "lamb": ("apex_tpu_torch/csrc/lamb.cu", "apex_tpu/kernels/optim.py:137"),
    "quantize_int8": ("apex_tpu_torch/csrc/quant8.cu",
                      "apex_tpu/parallel/compression.py:123"),
    "dequantize_int8": ("apex_tpu_torch/csrc/quant8.cu",
                        "apex_tpu/parallel/compression.py:128"),
    "spec_verify": ("apex_tpu_torch/csrc/spec_verify.cu",
                    "apex_tpu/kernels/fused_cc.py:453"),
    "mla_decode": ("apex_tpu_torch/csrc/mla_decode.cu",
                   "apex_tpu/contrib/mla_decode.py:62"),
    "quantize_int4": ("apex_tpu_torch/csrc/quant4.cu",
                      "apex_tpu/kernels/quant4.py:116"),
    "dequantize_int4": ("apex_tpu_torch/csrc/quant4.cu",
                        "apex_tpu/kernels/quant4.py:121"),
    "pack_int4": ("apex_tpu_torch/csrc/quant4.cu",
                  "apex_tpu/kernels/quant4.py:125"),
    "unpack_int4": ("apex_tpu_torch/csrc/quant4.cu",
                    "apex_tpu/kernels/quant4.py:132"),
    "quantize_pack_int4": ("apex_tpu_torch/csrc/quant4.cu",
                           "apex_tpu/kernels/fused_cc.py:598"),
    "unpack_dequantize_int4": ("apex_tpu_torch/csrc/quant4.cu",
                               "apex_tpu/kernels/fused_cc.py:606"),
    "tp_matmul": ("apex_tpu_torch/csrc/fused_cc_matmul.cu",
                  "apex_tpu/kernels/fused_cc.py:89"),
    # amp's kernels: K1 and K3 have no Pallas counterpart (the jnp ops they
    # replace), K2 and K4's stage 1 are #12's and #13's own rows, K4's stage
    # 2 replaces the parameter step of JAX's multi_tensor_lamb{,_mp}
    "multi_tensor_scale": ("apex_tpu_torch/csrc/multi_tensor_scale.cu",
                           "apex_tpu/ops/multi_tensor.py:46"),
    "sgd": ("apex_tpu_torch/csrc/sgd.cu", "apex_tpu/ops/multi_tensor.py:113"),
    "lamb_stage2": ("apex_tpu_torch/csrc/lamb.cu",
                    "apex_tpu/ops/multi_tensor.py:395"),
    # the rest of the optimizers: K5, K6 and K4's stage 1 by the public
    # op's per-tensor-decay route replace jnp ops (no Pallas counterpart)
    "adagrad": ("apex_tpu_torch/csrc/adagrad.cu",
                "apex_tpu/ops/multi_tensor.py:228"),
    "novograd": ("apex_tpu_torch/csrc/novograd.cu",
                 "apex_tpu/ops/multi_tensor.py:248"),
    "lamb_stage1_decay": ("apex_tpu_torch/csrc/lamb.cu",
                          "apex_tpu/ops/multi_tensor.py:431"),
    # K7, telemetry's per-tensor statistics: the jnp reductions of
    # numerics.py's _raw_sums (no Pallas counterpart)
    "multi_tensor_stats": ("apex_tpu_torch/csrc/stats.cu",
                           "apex_tpu/telemetry/numerics.py:82"),
}


def _us(ms):
    return "none" if ms is None else f"{ms * 1e3:.2f} us"


def main(argv):
    if len(argv) == 3 and argv[1] in ("--tp-worker", "--nccl-probe"):
        # one rank of tp_serve, started by the launcher
        if not torch.cuda.is_available():
            print("chip_smoke: a tp_serve rank needs a GPU", file=sys.stderr)
            return 1
        return (tp_worker if argv[1] == "--tp-worker" else nccl_probe)(
            argv[2])
    phases = argv[1:] or list(PHASES)
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; choose from {PHASES}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")

    phase_build()
    log(f"chip_smoke: phase build {time.perf_counter() - t_start:.1f} s")

    entries = []
    if "kernels" in phases:
        t_phase = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        entries = (check_rms_norm(gen) + check_window_attention(gen)
                   + check_gqa_decode(gen) + check_rms_bwd(gen)
                   + check_softmax(gen) + check_adam(gen)
                   + check_flash(gen) + check_layer_norm(gen)
                   + check_masked_softmax(gen) + check_lamb(gen)
                   + check_quant(gen) + check_spec_verify(gen)
                   + check_mla_decode(gen) + check_quant4(gen)
                   + check_tp_matmul(gen) + check_amp_kernels(gen)
                   + check_optimizer_kernels(gen) + check_stats(gen))
        check_per_row_attention(gen)
        check_kv_splits(gen)
        check_refusals()
        for e in entries:
            log(f"kernel {e['name']} [{e['shape']}]: max abs err "
                f"{e['max_abs_err']:.3e} rel {e['max_rel_err']:.3e} "
                f"({e['tolerance']}); {_us(e['ms'])} on the device "
                f"({_us(e['call_ms'])} a call, host included), plain "
                f"{_us(e['plain_ms'])}, library {_us(e['library_ms'])}"
                f"{' (' + e['library'] + ')' if 'library' in e else ''}, "
                f"bound {e['bound_ms'] * 1e3:.3f} us by {e['bound_by']}"
                + (f" (earlier bound {e['earlier_bound_ms'] * 1e3:.3f} us)"
                   if "earlier_bound_ms" in e else "")
                + (f" (the design's own products "
                   f"{e['design_bound_ms'] * 1e3:.3f} us)"
                   if "design_bound_ms" in e else "")
                + (f"; first design {_us(e['first_design_ms'])}"
                   if "first_design_ms" in e else "")
                + (f"; register path {_us(e['register_path_ms'])}"
                   if "register_path_ms" in e else "")
                + (f"; lse max abs err {e['lse_max_abs_err']:.3e}"
                   if "lse_max_abs_err" in e else ""))
        torch.cuda.empty_cache()
        log(f"chip_smoke: phase kernels "
            f"{time.perf_counter() - t_phase:.1f} s")

    by_path = {}
    if "serving" in phases:
        t_phase = time.perf_counter()
        by_path.update(phase_serving())
        torch.cuda.empty_cache()
        log(f"chip_smoke: phase serving "
            f"{time.perf_counter() - t_phase:.1f} s")
    runs = {"serve_bf16": phase_serve_bf16, "serve_int8": phase_serve_int8,
            "serve_spec": phase_serve_spec,
            "serve_prefix": phase_serve_prefix, "training": phase_training,
            "flash_training": phase_flash_training,
            "gpt2_training": phase_gpt2_training,
            "bert_training": phase_bert_training, "mha": phase_mha,
            "mla_decode": phase_mla_decode,
            "deepseek_v2_lite": phase_deepseek_v2_lite,
            "ddp_gpt2": phase_ddp_gpt2,
            "ddp_compressed": phase_ddp_compressed,
            "zero_gpt2": phase_zero_gpt2, "zero_bert": phase_zero_bert,
            "tp_dp": phase_tp_dp, "tp_gpt2": phase_tp_gpt2,
            "amp_gpt2": phase_amp_gpt2, "amp_o1_sgd": phase_amp_o1_sgd,
            "amp_bert": phase_amp_bert,
            "novograd_gpt2": phase_novograd_gpt2,
            "adagrad_gpt2": phase_adagrad_gpt2, "fp16_gpt2": phase_fp16_gpt2,
            "tp_serve": phase_tp_serve,
            "resilient_gpt2": phase_resilient_gpt2,
            "serve_guarded": phase_serve_guarded,
            "guarded_tp_dp": phase_guarded_tp_dp}
    for name in phases:  # in the order given, repeats included
        if name not in runs:
            continue  # kernels and serving ran above
        if not name.startswith("serve"):
            _SERVE_MODEL.clear()  # the serve phases' model
        t_phase = time.perf_counter()
        by_path.update(runs[name]())
        torch.cuda.empty_cache()
        log(f"chip_smoke: phase {name} {time.perf_counter() - t_phase:.1f} s")
    log(f"chip_smoke: phases {phases} in "
        f"{time.perf_counter() - t_start:.1f} s")
    if list(phases) != list(PHASES):
        log("chip_smoke: a partial run prints no result")
        return 0

    entries += _TP_ENTRIES  # tp_serve's rank shapes, after the main path's
    kernels, seen = [], set()
    for e in entries:  # the first (main-path) shape of each kernel
        if e["name"] in seen:
            continue
        seen.add(e["name"])
        others = [dict(shape=o["shape"], ms=o["ms"], plain_ms=o["plain_ms"],
                       bound_ms=o["bound_ms"], bound_by=o["bound_by"],
                       library_ms=o["library_ms"],
                       max_abs_err=o["max_abs_err"])
                  for o in entries if o["name"] == e["name"] and o is not e]
        src, replaces = SOURCES[e["name"]]
        paths = {path: counts[e["name"]] for path, counts in by_path.items()
                 if counts.get(e["name"])}
        kernels.append(dict(
            name=e["name"], route="cuda", source=src, replaces=replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=e["max_abs_err"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            call_ms=e["call_ms"], shape=e["shape"],
            **({"other_shapes": others} if others else {}),
            **{k: e[k] for k in ("library", "lse_max_abs_err",
                                 "earlier_bound_ms", "design_bound_ms",
                                 "first_design_ms", "register_path_ms")
               if k in e}))
    assert seen == set(SOURCES), (seen, set(SOURCES))
    assert all(k["launches"] > 0 for k in kernels
               if k["name"] not in KERNEL_PHASE_ONLY), kernels
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
