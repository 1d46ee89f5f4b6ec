#!/usr/bin/env python3
"""Drive apex_tpu_torch's serving path on one NVIDIA GPU and hold each of
its CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py

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
3. slice: ``GPTModel`` at TinyLlama-1.1B width (22 layers, seeded random
   weights) and ``generate(batch 8, prompt 128, 32 new tokens, greedy)``
   with every launch count set to 0 just before and read just after;
   the prefill and first decode step's logits against the same model
   run through the plain versions on the card; prefill ms and decode
   tokens/s.

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
    """Route the model's three kernel calls to their plain versions (for
    the reference run on the card); the wrappers themselves are left as
    they are."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import fused_cc, norm
    saved = (norm.rms_fwd, fused_cc.window_attention,
             gqa_decode.gqa_flash_decode)
    norm.rms_fwd = norm.rms_fwd_plain
    fused_cc.window_attention = fused_cc.window_attention_plain
    gqa_decode.gqa_flash_decode = gqa_decode.gqa_decode_plain
    try:
        yield
    finally:
        (norm.rms_fwd, fused_cc.window_attention,
         gqa_decode.gqa_flash_decode) = saved


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
    the library call (and the kernel's eager call time, host included)."""
    return dict(name=name, shape=shape, max_abs_err=max_abs(got, want),
                max_rel_err=max_rel(got, want), tolerance=tolerance,
                ms=device_ms(kernel), call_ms=call_ms(kernel),
                plain_ms=device_ms(plain, iters=5),
                library_ms=device_ms(library), bound_ms=bound_ms_by[0],
                bound_by=bound_ms_by[1])


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


def check_refusals():
    """On a CUDA tensor a wrapper launches its kernel or raises: what the
    kernels do not take is refused, never sent to the plain version."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import fused_cc, norm, registry

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
    assert registry.launches() == before, "a refused call was counted"
    log("kernels: malformed CUDA inputs are refused (dtype, layout, range, "
        "head dim)")


# ---------------------------------------------------------------- phase 3

def profile_window(label, fn, top=6):
    """Device busy share of one call of ``fn`` under torch.profiler (the
    kernels' summed time over the span from the first kernel's start to
    the last one's end) and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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


def phase_slice():
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
    t0 = time.perf_counter()
    tokens = generate(model, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = registry.launches()
    forwards = NEW_TOKENS  # one prefill + NEW_TOKENS - 1 decode steps
    expected = {"rms_norm": (2 * cfg.num_layers + 1) * forwards,
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

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def spread(xs):
        xs = sorted(xs)
        return (f"median {statistics.median(xs):.2f} ms, min {xs[0]:.2f}, "
                f"max {xs[-1]:.2f} over {len(xs)}")

    run_prefill()  # warm
    prefill_ms = [wall_ms(run_prefill)[0] for _ in range(7)]
    cache, logits = run_prefill()
    nxt = tokens[:, PROMPT:PROMPT + 1]

    def step(i):
        return decode_step(
            model, cache, nxt,
            torch.full((BATCH, 1), PROMPT + i, device=model.device))

    step_ms = []
    for i in range(NEW_TOKENS - 1):
        ms, (cache, logits) = wall_ms(lambda: step(i))
        step_ms.append(ms)
    med = statistics.median(step_ms)
    log(f"slice: prefill ({BATCH}x{PROMPT} tokens) {spread(prefill_ms)}; "
        f"decode step {spread(step_ms)} = {BATCH / med * 1e3:.1f} tokens/s "
        f"at batch {BATCH} (host clock, synchronized); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_window("prefill", run_prefill)
    cache, _ = run_prefill()
    profile_window("decode step", lambda: step(0))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")

    phase_build()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = (check_rms_norm(gen) + check_window_attention(gen)
               + check_gqa_decode(gen))
    check_refusals()
    for e in entries:
        log(f"kernel {e['name']} [{e['shape']}]: max abs err "
            f"{e['max_abs_err']:.3e} rel {e['max_rel_err']:.3e} "
            f"({e['tolerance']}); {e['ms'] * 1e3:.2f} us on the device "
            f"({e['call_ms'] * 1e3:.2f} us a call, host included), plain "
            f"{e['plain_ms'] * 1e3:.2f} us, library "
            f"{e['library_ms'] * 1e3:.2f} us, bound "
            f"{e['bound_ms'] * 1e3:.3f} us by {e['bound_by']}")

    launches = phase_slice()

    sources = {"rms_norm": ("apex_tpu_torch/csrc/rms_norm.cu",
                            "apex_tpu/kernels/norm.py:85"),
               "window_attention": ("apex_tpu_torch/csrc/window_attention.cu",
                                    "apex_tpu/kernels/fused_cc.py:313"),
               "gqa_decode": ("apex_tpu_torch/csrc/gqa_decode.cu",
                              "apex_tpu/contrib/gqa_decode.py:66")}
    kernels, seen = [], set()
    for e in entries:  # the first (main-path) shape of each kernel
        if e["name"] in seen:
            continue
        seen.add(e["name"])
        src, replaces = sources[e["name"]]
        kernels.append(dict(
            name=e["name"], route="cuda", source=src, replaces=replaces,
            launches=launches[e["name"]], max_abs_err=e["max_abs_err"],
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            call_ms=e["call_ms"], shape=e["shape"]))
    assert all(k["launches"] > 0 for k in kernels), kernels
    log(json.dumps({"kernels": kernels, "card": card}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
