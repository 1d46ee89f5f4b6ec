#!/usr/bin/env python3
"""Drive apex_tpu_torch's serving path and training step on one NVIDIA
GPU and hold each of its CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py kernels        # build + kernel checks only
    python3 chip_smoke.py gpt2_training  # any subset of the phases

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build: compile every ``apex_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, all started together) and print the build time,
   ptxas's register and shared-memory report, and the card's name and
   power limit.
2. kernels: call each kernel's wrapper on tensors on the card at the
   shapes the serving path gives it (TinyLlama-1.1B: batch 8, prompt
   128, 32 query heads in 4 KV groups, head dim 64, hidden 2048, a
   2048-row cache), hold the result against the plain version on the
   same inputs within a stated tolerance, also on the options the path
   does not take (window, softcap, ragged T, head dim 128, fp32), and
   time kernel, plain version and one PyTorch library call as yardstick.
   The training kernels likewise at the training step's shapes (RMSNorm
   backward-dx [2048, 2048] bf16, causal softmax forward and backward
   [64, 1024, 1024] fp32, Adam over TinyLlama's 179 fp32 tensors) and
   off them (fp32, bf16, sk > sq, 16384 keys, L2 decay, the noop flag,
   more tensors than one launch takes). The flash kernels at the flash
   training step's shape ([2, 32, 2048, 64] fp32, causal; and bf16) and
   off it (full, windows, ALiBi, head dims 128 and 256, tails, one
   head). LayerNorm forward and backward-dx at GPT-2's [8192, 1024]
   bf16 rows, the scaled and masked softmax at BERT-large's [64, 16,
   128, 128] fp32 scores with a [64, 1, 128, 128] mask (off the path:
   partial masks, fully masked rows, which are NaN as in JAX, uint8
   masks, 16384 keys), LAMB over BERT-large's 302 tensors (off the path:
   L2 decay, no clip, noop). Malformed CUDA inputs to every wrapper are
   refused and not counted.
3. serving: ``GPTModel`` at TinyLlama-1.1B width (22 layers, seeded
   random weights) and ``generate(batch 8, prompt 128, 32 new tokens,
   greedy)`` with every launch count set to 0 just before and read just
   after; the prefill and first decode step's logits against the same
   model run through the plain versions on the card; prefill ms and
   decode tokens/s.
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

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

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

# Tolerances, kernel against plain version on the same inputs:
# RMSNorm: the same fp32 operations with the sum in another order, so a
# bf16 output may round the other way: one bf16 ulp (2**-7 relative).
NORM_RTOL, NORM_ATOL = 2.0 ** -7, 1e-6
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


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


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
    from apex_tpu_torch.contrib import fmha, gqa_decode
    from apex_tpu_torch.kernels import fused_cc, norm, optim, softmax
    swaps = [(norm, "rms_fwd", norm.rms_fwd_plain),
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

def phase_build():
    from apex_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for line in report.splitlines():
        if line.startswith("== ") or "registers" in line:
            log("  " + line.strip())
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


def _attention_bound(b, g, rep, d, w, start, window):
    keys, lo = _visible(start, w, window)
    live_rows = start + w - lo
    nbytes = (w * b * g * rep * d * 2          # queries, bf16
              + 2 * live_rows * b * g * d * 2  # live K and V rows, bf16
              + w * b * g * rep * d * 4)       # fp32 output
    ops = 4 * d * b * g * rep * keys           # QK^T and PV products
    return bound(nbytes, ops, BF16_TENSOR_OPS_PER_S)


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
    got = fused_cc.window_attention(q, k, v, 0, sm)
    want = fused_cc.window_attention_plain(q, k, v, 0, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    # yardstick: SDPA over the live rows, heads-major views of the same
    # tensors (start 0 and w == live rows: plain causal)
    q_l = q.reshape(PROMPT, BATCH, n, d).permute(1, 2, 0, 3)
    k_l = k[:PROMPT].permute(1, 2, 0, 3)
    v_l = v[:PROMPT].permute(1, 2, 0, 3)
    return [entry(
        "window_attention",
        f"qg[{PROMPT},{BATCH},{g},{rep},{d}] bf16, cache[{T},{BATCH},{g},"
        f"{d}] bf16, start 0", got, want, f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: fused_cc.window_attention(q, k, v, 0, sm),
        lambda: fused_cc.window_attention_plain(q, k, v, 0, sm),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q_l, k_l, v_l, is_causal=True, scale=sm, enable_gqa=True),
        _attention_bound(BATCH, g, rep, d, PROMPT, 0, None))]


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
    got = gqa_decode.gqa_flash_decode(q, k, v, L, sm)
    want = gqa_decode.gqa_decode_plain(q, k, v, L, sm)
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    q_l = q.reshape(BATCH, n, 1, d)
    k_l = k[:L].permute(1, 2, 0, 3)
    v_l = v[:L].permute(1, 2, 0, 3)
    return [entry(
        "gqa_decode",
        f"q[{BATCH},{g},{rep},{d}] bf16, cache[{T},{BATCH},{g},{d}] bf16, "
        f"length {L}", got, want, f"rtol {ATTN_TOL} atol {ATTN_TOL}",
        lambda: gqa_decode.gqa_flash_decode(q, k, v, L, sm),
        lambda: gqa_decode.gqa_decode_plain(q, k, v, L, sm),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q_l, k_l, v_l, scale=sm, enable_gqa=True),
        _attention_bound(BATCH, g, rep, d, 1, L - 1, None))]


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
    # the path's call: dy of the bf16 norm output, the bf16 residual
    x = _randn(gen, rows, h, scale=3.0)
    dy = _randn(gen, rows, h)
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
    return [entry(
        "rms_bwd", f"dy, x [{rows},{h}] bf16 -> dx bf16", got, want,
        f"rtol {NORM_BWD_RTOL[torch.bfloat16]} atol 1e-5*max|dx|",
        lambda: norm.rms_bwd_dx(dy, x, w, eps),
        lambda: norm.rms_bwd_dx_plain(dy, x, w, eps), library,
        bound(rows * h * 2 * 3 + h * 4, 10 * rows * h, FP32_OPS_PER_S))]


def _live_keys(sq, sk):
    """Keys the causal mask leaves live, summed over the sq rows."""
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def check_softmax(gen):
    from apex_tpu_torch.kernels import softmax
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, sk in ((4, 128, 128), (3, 100, 357), (5, 33, 1000),
                          (2, 7, softmax.MAX_KEYS)):
            for scale in (1.0, 0.125):
                x = _randn(gen, b, sq, sk, dtype=dtype, scale=4.0)
                got = softmax.causal_softmax_fwd(x, scale)
                want = softmax.causal_softmax_fwd_plain(x, scale)
                torch.cuda.synchronize()
                assert got.dtype == dtype and got.shape == x.shape
                live = torch.ones(sq, sk, dtype=torch.bool,
                                  device="cuda").tril(sk - sq)
                assert (got[:, ~live] == 0).all(), "a masked key is not 0"
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=SOFTMAX_RTOL[dtype],
                                           atol=SOFTMAX_ATOL)
                dy = _randn(gen, b, sq, sk, dtype=dtype)
                got = softmax.softmax_bwd(want, dy, scale)
                ref = softmax.softmax_bwd_plain(want, dy, scale)
                torch.cuda.synchronize()
                assert got.dtype == dtype
                assert_close_scaled(got, ref, SOFTMAX_BWD_RTOL[dtype])
    # the path: [b * heads, s, s] fp32 scores, scale 1
    B = TRAIN_BATCH * MODEL["num_attention_heads"]
    S = TRAIN_SEQ
    x = _randn(gen, B, S, S, dtype=torch.float32, scale=4.0)
    got = softmax.causal_softmax_fwd(x, 1.0)
    want = softmax.causal_softmax_fwd_plain(x, 1.0)
    torch.testing.assert_close(got, want, rtol=SOFTMAX_RTOL[torch.float32],
                               atol=SOFTMAX_ATOL)
    live = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    x_masked = x.masked_fill(~live, float("-inf"))
    keys = _live_keys(S, S)
    fwd = entry(
        "causal_softmax", f"x [{B},{S},{S}] fp32, scale 1", got, want,
        f"rtol {SOFTMAX_RTOL[torch.float32]} atol {SOFTMAX_ATOL}",
        lambda: softmax.causal_softmax_fwd(x, 1.0),
        lambda: softmax.causal_softmax_fwd_plain(x, 1.0),
        lambda: torch.softmax(x_masked, dim=-1),  # the mask applied before
        bound(B * keys * 4 + B * S * S * 4, 5 * B * keys, FP32_OPS_PER_S))
    y = want
    dy = _randn(gen, B, S, S, dtype=torch.float32)
    got = softmax.softmax_bwd(y, dy, 1.0)
    ref = softmax.softmax_bwd_plain(y, dy, 1.0)
    assert_close_scaled(got, ref, SOFTMAX_BWD_RTOL[torch.float32])
    bwd = entry(
        "softmax_bwd", f"y, dy [{B},{S},{S}] fp32, scale 1", got, ref,
        f"rtol {SOFTMAX_BWD_RTOL[torch.float32]} atol 1e-5*max|dx|",
        lambda: softmax.softmax_bwd(y, dy, 1.0),
        lambda: softmax.softmax_bwd_plain(y, dy, 1.0),
        lambda: torch._softmax_backward_data(dy, y, -1, torch.float32),
        bound(3 * B * S * S * 4, 5 * B * S * S, FP32_OPS_PER_S))
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
    rtol, scaled_atol = FLASH_TOL[dtype]
    assert_close_scaled(got, want, rtol, scaled_atol)


def _flash_check(q, k, v, do, slopes, causal, window):
    """Each flash kernel against its plain version on the same inputs:
    the forward's o and lse, then dq and dk/dv from the kernel's o and
    lse (so the backward is held alone). Returns the results."""
    from apex_tpu_torch.contrib import fmha
    scale = q.shape[-1] ** -0.5
    o, lse = fmha.flash_fwd(q, k, v, scale, causal, window, slopes)
    o_p, lse_p = fmha.flash_fwd_plain(q, k, v, scale, causal, window, slopes)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    _flash_close(o, o_p, q.dtype)
    torch.testing.assert_close(lse, lse_p, rtol=FLASH_LSE_RTOL,
                               atol=FLASH_LSE_RTOL)
    delta = fmha._delta(o, do)
    args = (q, k, v, do, lse, delta, scale, causal, window, slopes)
    dq = fmha.flash_dq(*args)
    dk, dv = fmha.flash_dkv(*args)
    dq_p = fmha.flash_dq_plain(*args)
    dk_p, dv_p = fmha.flash_dkv_plain(*args)
    torch.cuda.synchronize()
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.dtype == q.dtype
        _flash_close(got, want, q.dtype)
    return dict(o=(o, o_p), lse=(lse, lse_p), dq=(dq, dq_p),
                dkv=(torch.cat([dk, dv]), torch.cat([dk_p, dv_p])),
                args=args)


def check_flash(gen):
    from apex_tpu_torch.contrib import fmha
    # off the path: (b, n, s, d, dtype, causal, window, alibi); s = 200,
    # 300 and 77 leave a ragged last tile, b*n = 1 a single head
    f32, bf16 = torch.float32, torch.bfloat16
    for b, n, s, d, dtype, causal, window, alibi in (
            (1, 1, 200, 64, f32, True, None, False),
            (2, 2, 256, 64, f32, False, None, False),
            (1, 2, 256, 64, f32, True, 1, False),
            (1, 2, 300, 64, bf16, True, 37, True),
            (1, 2, 512, 64, f32, True, 256, False),
            (1, 2, 256, 64, f32, True, None, True),
            (2, 2, 256, 64, bf16, False, None, True),
            (1, 2, 200, 128, f32, True, 37, False),
            (1, 2, 256, 128, bf16, False, None, True),
            (1, 2, 200, 256, f32, True, None, False),
            (1, 2, 128, 256, bf16, False, None, False),
            (1, 3, 77, 256, f32, True, 256, True)):
        _flash_check(*_flash_inputs(gen, b, n, s, d, dtype, alibi), causal,
                     window)
    log("kernels: flash fwd, dq and dk/dv match their plain versions off "
        "the path (full, windows 1/37/256, ALiBi, head dims 128 and 256, "
        "fp32 and bf16, ragged tails, one head)")

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
        peak = FP32_OPS_PER_S if dtype == torch.float32 else (
            BF16_TENSOR_OPS_PER_S)
        q, k, v, do, _ = _flash_inputs(gen, B, n, S, d, dtype, False)
        r = _flash_check(q, k, v, do, None, True, None)
        scale = d ** -0.5
        args = r["args"]
        shape = f"q,k,v [{B},{n},{S},{d}] {str(dtype)[6:]}, causal"
        tol = (f"rtol {FLASH_TOL[dtype][0]} atol "
               f"{FLASH_TOL[dtype][1]}*max|want|")
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
        bnsd, bns = B * n * S * d * es, B * n * S * 4
        fwd = entry(
            "flash_fwd", shape, *r["o"], tol,
            lambda: fmha.flash_fwd(q, k, v, scale, True),
            lambda: fmha.flash_fwd_plain(q, k, v, scale, True), None,
            bound(4 * bnsd + bns, 4 * d * pairs, peak))
        fwd["library_ms"] = sdpa_fwd_ms
        fwd["lse_max_abs_err"] = max_abs(*r["lse"])
        dq = entry(
            "flash_dq", shape, *r["dq"], tol,
            lambda: fmha.flash_dq(*args), lambda: fmha.flash_dq_plain(*args),
            None, bound(5 * bnsd + 2 * bns, 6 * d * pairs, peak))
        dkv = entry(
            "flash_dkv", shape, *r["dkv"], tol,
            lambda: fmha.flash_dkv(*args),
            lambda: fmha.flash_dkv_plain(*args), None,
            bound(6 * bnsd + 2 * bns, 8 * d * pairs, peak))
        fwd["library"] = "SDPA forward, eager"
        for e in (dq, dkv):
            e["library_ms"] = sdpa_bwd_ms
            e["library"] = "SDPA backward, dq+dk+dv: fwd+bwd - fwd, eager"
        entries += [fwd, dq, dkv]
        del q, k, v, do, r, args, ql, kl, vl
        torch.cuda.empty_cache()
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


def check_adam(gen):
    import math

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
    steps = [torch.ones((), device="cuda") for _ in shapes]
    result = dict(
        name="adam", shape=f"{len(shapes)} fp32 tensors, {n} params",
        max_abs_err=max(err), max_rel_err=max(rel),
        tolerance=f"rel {ADAM_RTOL} (bit-identical expected)",
        ms=device_ms(lambda: optim.adam(noop0, g, *ker, **kw), iters=5,
                     replays=2),
        call_ms=call_ms(lambda: optim.adam(noop0, g, *ker, **kw), 5, 1),
        plain_ms=call_ms(lambda: optim.adam_plain(noop0, g, *pln, **kw),
                         3, 1),
        library_ms=call_ms(lambda: torch._fused_adamw_(
            pln[0], g, pln[1], pln[2], [], steps, lr=lr, beta1=b1,
            beta2=b2, weight_decay=0.0, eps=eps, amsgrad=False,
            maximize=False), 5, 1))
    result["bound_ms"], result["bound_by"] = bound(28 * n, 15 * n,
                                                    FP32_OPS_PER_S)
    log(f"kernels: adam over the path's {len(shapes)} tensors: "
        f"{launched} launches")
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
    # the path: the bf16 residual stream in, bf16 out
    h = GPT2["hidden_size"]
    rows = GPT2_BATCH * GPT2_SEQ
    w = 1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    x = _randn(gen, rows, h, scale=3.0)
    dy = _randn(gen, rows, h)
    bf16 = torch.bfloat16
    got = norm.ln_fwd(x, w, b, eps, bf16)
    want = norm.ln_fwd_plain(x, w, b, eps, bf16)
    assert_close_scaled(got, want, LN_RTOL[bf16])
    w_lib, b_lib = w.to(bf16), b.to(bf16)  # F.layer_norm takes one dtype
    fwd = entry(
        "layer_norm", f"x [{rows},{h}] bf16->bf16, fp32 weight and bias", got,
        want, f"rtol {LN_RTOL[bf16]} atol 1e-5*max|y|",
        lambda: norm.ln_fwd(x, w, b, eps, bf16),
        lambda: norm.ln_fwd_plain(x, w, b, eps, bf16),
        lambda: torch.nn.functional.layer_norm(x, (h,), w_lib, b_lib, eps),
        bound(rows * h * 2 * 2 + 2 * h * 4, 8 * rows * h, FP32_OPS_PER_S))
    got = norm.ln_bwd_dx(dy, x, w, eps)
    want = norm.ln_bwd_dx_plain(dy, x, w, eps)
    assert_close_scaled(got, want, LN_RTOL[bf16])
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


def _key_mask(gen, shape, share=0.35, nan_row=False):
    """A bool mask (True = masked) with ``share`` of the keys masked and
    key 0 of every row live; with ``nan_row`` one row fully masked."""
    m = torch.rand(*shape, generator=gen, device="cuda") < share
    m[..., 0] = False
    if nan_row:
        m[(0,) * (m.dim() - 2) + (1,)] = True
    return m


def check_masked_softmax(gen):
    """The scaled (no mask) and scaled-masked softmax forwards: options
    off the path (fp32 and bf16, masks broadcast over heads, full ones,
    one [sq, sk] band, a query-side [b, 1, sq, 1] one broadcast over the
    keys, uint8, keys strided in memory, a fully masked row, 16384 keys),
    then the BERT step's [64, 16, 128, 128] fp32 scores with its [64, 1,
    128, 128] mask."""
    from apex_tpu_torch.kernels import softmax
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
                for mask in (m, m.to(torch.uint8), strided):
                    got = softmax.scaled_masked_softmax_fwd(x, mask, scale)
                    want = softmax.scaled_masked_softmax_fwd_plain(x, mask,
                                                                   scale)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype and got.shape == x.shape
                    full = m.expand(xs)
                    dead = full.all(-1)
                    assert dead.any() and torch.isnan(got[dead]).all(), \
                        "a fully masked row is not NaN (the JAX value)"
                    assert torch.isnan(want[dead]).all()
                    live = ~dead
                    assert (got[full & live[..., None]] == 0).all(), \
                        "a masked key is not 0"
                    torch.testing.assert_close(
                        got[live].float(), want[live].float(),
                        rtol=SOFTMAX_RTOL[dtype], atol=SOFTMAX_ATOL)
                got = softmax.scaled_softmax_fwd(x, scale)
                want = softmax.scaled_softmax_fwd_plain(x, scale)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=SOFTMAX_RTOL[dtype],
                                           atol=SOFTMAX_ATOL)
    log("kernels: scaled_softmax and masked_softmax match their plain "
        "versions off the path (fp32/bf16, masks [b,1,sq,sk], [b,n,sq,sk], "
        "[sq,sk], [b,1,sq,1], bool and uint8, keys strided, 16384 keys); "
        "fully masked rows are NaN (NaN for NaN), masked keys exactly 0")
    # the path: BERT-large's scores, its all-ones padding mask (nothing
    # masked) and a partial mask
    b, n, s = BERT_BATCH, BERT["num_attention_heads"], BERT_SEQ
    x = _randn(gen, b, n, s, s, dtype=torch.float32, scale=4.0)
    keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask = ~(keep[:, None, None, :] & keep[:, None, :, None])
    partial = _key_mask(gen, (b, 1, s, s))
    for m in (partial, mask):
        got = softmax.scaled_masked_softmax_fwd(x, m, 1.0)
        want = softmax.scaled_masked_softmax_fwd_plain(x, m, 1.0)
        torch.testing.assert_close(got, want,
                                   rtol=SOFTMAX_RTOL[torch.float32],
                                   atol=SOFTMAX_ATOL)
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
    return [scaled, masked]


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
    refused(TypeError, lambda: optim.adam(noop, [t[0].bfloat16()], t, t, t,
                                          **kw))
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
    assert registry.launches() == before, "a refused call was counted"
    log("kernels: malformed CUDA inputs are refused (dtype, layout, range, "
        "head dim, shapes, list lengths, window, slopes, lse/delta, "
        "weight/bias, masks that do not broadcast, clip)")


# ------------------------------------------------------------- phases 3, 4

def profile_window(label, fn, top=6, watch=()):
    """Device busy share of one call of ``fn`` under torch.profiler (the
    kernels' summed time over the span from the first kernel's start to
    the last one's end), the kernels that take most of it, and the summed
    time of the kernels whose names contain each string of ``watch``."""
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
        return
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
    for part in watch:
        names = [k for k in by_name if part in k]
        us = sum(by_name[k] for k in names)
        n = sum(1 for e in kernels if part in e.name)
        log(f"  kernels named *{part}*: {us:.1f} us in {n} launches "
            f"({us / busy:.4f} of the busy time)")


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
    for name, got, want in (("prefill", k0, p0), ("step 1", k1, p1)):
        assert torch.isfinite(got).all(), name
        top2 = torch.topk(want, 2, dim=-1).values
        log(f"slice: {name} logits kernels vs plain: max abs err "
            f"{max_abs(got, want):.3e} (tolerance {LOGIT_TOL}), logit std "
            f"{want.std().item():.3f}, smallest top-2 gap "
            f"{(top2[:, 0] - top2[:, 1]).min().item():.3e}")
        torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)
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
    return {"serving": launches}


def _rel_fro(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def train_steps(label, model, loss_of, make_opt, per_step, work,
                update_rtol=(TRAIN_UPDATE_RTOL, TRAIN_TENSOR_UPDATE_RTOL),
                falls_from=0, linear_below=None):
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
    is printed. Returns the launches of the
    counted steps."""
    import math

    from apex_tpu_torch.kernels import registry
    params = dict(model.named_parameters())
    w0 = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    expected = {**dict.fromkeys(registry.launches(), 0), **per_step}

    def step(opt):
        loss = loss_of()
        loss.backward()
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
        loss.backward()
        if k == 0:
            g1 = {n: p.grad.detach().to("cpu", copy=True)
                  for n, p in params.items()}
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
                  for n, p in params.items()}
            moved = sum(not torch.equal(p1[n], w0[n]) for n in params)
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
    profile_window(f"{label} step", lambda: step(opt), top=10,
                   watch=PROFILE_WATCH)

    # step 1 again from the same weights, through the plain versions
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(w0[n])
    opt = make_opt(model.parameters())
    registry.reset()
    with plain_versions():
        loss = loss_of()
        loss.backward()
        grad_err = {n: _rel_fro(g1[n].cuda(), p.grad)
                    for n, p in params.items()}
        opt.step()
        opt.zero_grad()
    assert not any(registry.launches().values()), registry.launches()
    loss_err = abs(losses[0] - loss.item()) / abs(loss.item())
    num = den = num1 = den1 = flipped = flipped_linear = 0.0
    below = None if linear_below is None else linear_below(g1)
    update_err = {}
    for n, p in params.items():
        want = p.detach() - w0[n].cuda()
        got = p1[n].cuda() - w0[n].cuda()
        update_err[n] = _rel_fro(got, want)
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
        f"({worst_u}; tolerance {update_rtol[1]}); updates of opposite "
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
    return {"gpt2_training": train_steps(
        "gpt2 training", model, lambda: gpt_loss_fn(model(tokens), labels),
        lambda ps: FusedAdam(ps, lr=GPT2_LR), per_step,
        (GPT2_BATCH * GPT2_SEQ, "tokens"))}


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
                "lamb": math.ceil(n_tensors / optim.MAX_TENSORS)}

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
        linear_below=lamb_linear_below)

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


# kernel name parts whose summed device time a training profile prints
PROFILE_WATCH = ("ln_fwd_kernel", "ln_bwd_dx_kernel", "masked_fwd_kernel",
                 "causal_fwd_kernel", "::bwd_kernel<", "lamb_kernel",
                 "adam_kernel", "::fwd_kernel<", "::dq_kernel<",
                 "::dkv_kernel<", "rms_")
PHASES = ("kernels", "serving", "training", "flash_training",
          "gpt2_training", "bert_training", "mha")
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
}


def _us(ms):
    return "none" if ms is None else f"{ms * 1e3:.2f} us"


def main(argv):
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

    entries = []
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        entries = (check_rms_norm(gen) + check_window_attention(gen)
                   + check_gqa_decode(gen) + check_rms_bwd(gen)
                   + check_softmax(gen) + check_adam(gen)
                   + check_flash(gen) + check_layer_norm(gen)
                   + check_masked_softmax(gen) + check_lamb(gen))
        check_refusals()
        for e in entries:
            log(f"kernel {e['name']} [{e['shape']}]: max abs err "
                f"{e['max_abs_err']:.3e} rel {e['max_rel_err']:.3e} "
                f"({e['tolerance']}); {_us(e['ms'])} on the device "
                f"({_us(e['call_ms'])} a call, host included), plain "
                f"{_us(e['plain_ms'])}, library {_us(e['library_ms'])}"
                f"{' (' + e['library'] + ')' if 'library' in e else ''}, "
                f"bound {e['bound_ms'] * 1e3:.3f} us by {e['bound_by']}"
                + (f"; lse max abs err {e['lse_max_abs_err']:.3e}"
                   if "lse_max_abs_err" in e else ""))
        torch.cuda.empty_cache()

    by_path = {}
    if "serving" in phases:
        by_path.update(phase_serving())
        torch.cuda.empty_cache()
    for name, run in (("training", phase_training),
                      ("flash_training", phase_flash_training),
                      ("gpt2_training", phase_gpt2_training),
                      ("bert_training", phase_bert_training),
                      ("mha", phase_mha)):
        if name in phases:
            by_path.update(run())
            torch.cuda.empty_cache()
    log(f"chip_smoke: phases {phases} in "
        f"{time.perf_counter() - t_start:.1f} s")
    if list(phases) != list(PHASES):
        log("chip_smoke: a partial run prints no result")
        return 0

    kernels, seen = [], set()
    for e in entries:  # the first (main-path) shape of each kernel
        if e["name"] in seen:
            continue
        seen.add(e["name"])
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
            **{k: e[k] for k in ("library", "lse_max_abs_err") if k in e}))
    assert seen == set(SOURCES), (seen, set(SOURCES))
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
