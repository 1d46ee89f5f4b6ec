"""Hashes of FusedAdam's, FusedLAMB's, FusedSGD's, FusedNovoGrad's and
FusedAdagrad's state after plain steps, and of amp's unscale, on the
card, for holding two checkouts' optimizer paths to each other bit for
bit.

From the root of a checkout (its ``apex_tpu_torch`` is the one
imported), on one NVIDIA GPU:

    python3 optim_turns.py [CALLS]

Four plain ``FusedAdam(lr=1e-4)`` steps over GPT-2 345M's 293 parameter
shapes (fp32) and four plain ``FusedLAMB(lr=1e-3, weight_decay=0.01)``
steps over BERT-large's 302, four plain ``FusedSGD(lr=0.03,
momentum=0.9)`` steps over GPT-2's (the first run and the steps after),
on seeded random parameters and gradients (no amp, no ``found_inf``, no
``scale``); then ``multi_tensor_scale`` over GPT-2's gradients in amp
O2's dtypes (bf16, the norm layers' fp32), in place with a scale of
2^-16, four times; then amp's steps as ``chip_smoke.py``'s amp phases
take them, on seeded random weights and gradients (no forward):
BERT-large under O2 with ``FusedMixedPrecisionLamb(lr=1e-3,
weight_decay=0.01)`` and GPT-2 345M under O1 with ``FusedSGD(lr=0.03,
momentum=0.9)``; then four plain ``FusedNovoGrad(lr=0.01,
weight_decay=0.001)`` and ``FusedAdagrad(lr=1e-4)`` steps over GPT-2's
shapes (skipped, with a line saying so, in a checkout that has not
these optimizers). Prints one line a case: the SHA-256 of every
parameter and its optimizer state after the steps (NovoGrad's per-tensor
second moments, its group's ``exp_avg_sq``, included; of every gradient
and the flag for the unscale; of the parameters for amp's steps), the
step count,
and the medians over CALLS further calls (default 7) of ``opt.step()``
(of the unscale): its device time (CUDA events around each call,
gradients unchanged) and its host time (the wall time of the call
itself, the device not waited for). Run it in two checkouts in turns
(A, B, B, A): equal hashes mean the two paths give the same bits;
compare times only within one call.
"""

import hashlib
import statistics
import sys
import time

import torch

sys.path.insert(0, ".")

from apex_tpu_torch.amp.frontend import is_norm_name  # noqa: E402
from apex_tpu_torch.models import (  # noqa: E402
    BertModel,
    GPTModel,
    TransformerConfig,
)
from apex_tpu_torch.ops.multi_tensor import multi_tensor_scale  # noqa: E402
from apex_tpu_torch.optimizers import (  # noqa: E402
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    FusedSGD,
)
from apex_tpu_torch.transformer.enums import AttnMaskType  # noqa: E402

STEPS = 4
TIMED = int(sys.argv[1]) if len(sys.argv) > 1 else 7
WIDTH = dict(hidden_size=1024, num_layers=24, num_attention_heads=16,
             ffn_hidden_size=4096, max_position_embeddings=1024)
GPT2 = dict(WIDTH, vocab_size=50304)
BERT = dict(WIDTH, vocab_size=30528, max_position_embeddings=512)


def _shapes(model):
    return [tuple(p.shape) for p in model.parameters()]


def _times(fn):
    """Median device ms and median host ms of ``fn`` over TIMED calls:
    CUDA events around each call, and the wall time of the call itself
    (the device not waited for inside it)."""
    device, host = [], []
    for _ in range(TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(host)


def _digest(tensors):
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                      .tobytes())
    return digest.hexdigest()


def run(label, shapes, make_opt, seed, state_names=("exp_avg",
                                                    "exp_avg_sq"),
        group_names=()):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.nn.Parameter(
        0.02 * torch.randn(s, generator=gen, device="cuda")) for s in shapes]
    opt = make_opt(params)
    for _ in range(STEPS):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        opt.step()
    torch.cuda.synchronize()
    digest = _digest([*(t for p in params for t in (
        p.detach(), *(opt.state[p][name] for name in state_names))),
        *(g[name] for g in opt.param_groups for name in group_names)])
    step = int(torch.as_tensor(opt.param_groups[0]["step"]).reshape(-1)[0])
    device, host = _times(opt.step)
    print(f"{label}: {len(shapes)} tensors, {sum(p.numel() for p in params)} "
          f"params, step {step}: sha256 {digest}; opt.step() median "
          f"{device:.3f} ms on the device, {host:.3f} ms on the host over "
          f"{TIMED}", flush=True)
    del params, opt
    torch.cuda.empty_cache()


def unscale(label, shapes, seed):
    """``multi_tensor_scale`` in place over gradients of ``shapes`` ((shape,
    dtype) pairs), scale 2^-16, STEPS times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = [(65536.0 * torch.randn(s, generator=gen, device="cuda")).to(dt)
             for s, dt in shapes]
    flag = torch.zeros(1, device="cuda")
    for _ in range(STEPS):
        multi_tensor_scale(flag, [grads, grads], 2.0 ** -16)
    torch.cuda.synchronize()
    digest = _digest([*grads, flag])
    device, host = _times(
        lambda: multi_tensor_scale(flag, [grads, grads], 1.0))
    print(f"{label}: {len(shapes)} tensors, {sum(g.numel() for g in grads)} "
          f"elements, flag {flag.item()}: sha256 {digest}; "
          f"multi_tensor_scale median {device:.3f} ms on the device, "
          f"{host:.3f} ms on the host over {TIMED}", flush=True)
    del grads
    torch.cuda.empty_cache()


def amp_steps(label, model, opt_level, make_inner, seed):
    """``opt.step()`` of ``amp.initialize(model, make_inner(params),
    opt_level)`` STEPS times over seeded gradients in the parameters'
    dtypes (the model's weights seeded too)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import init_weights
    init_weights(model, seed)
    amp.initialize(model, None, opt_level=opt_level, verbosity=0)
    params = list(model.parameters())
    opt = amp.initialize(model, make_inner(params), opt_level=opt_level,
                         verbosity=0)[1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(STEPS):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen,
                                 device="cuda").to(p.dtype)
        opt.step()
    torch.cuda.synchronize()
    digest = _digest(p.detach() for p in params)
    device, host = _times(opt.step)
    print(f"{label}: {len(params)} tensors, "
          f"{sum(p.numel() for p in params)} params, dtypes "
          f"{sorted({str(p.dtype) for p in params})}: sha256 {digest}; "
          f"opt.step() median {device:.3f} ms on the device, {host:.3f} ms "
          f"on the host over {TIMED}", flush=True)
    amp.initialize(model, None, enabled=False)  # the O1 policy off again
    del params, opt, model
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("optim_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpt2_model = GPTModel(TransformerConfig(**GPT2), device="meta")
    gpt2 = _shapes(gpt2_model)
    bert = _shapes(BertModel(TransformerConfig(
        **BERT, attn_mask_type=AttnMaskType.padding), device="meta"))
    run("FusedAdam, GPT-2 345M", gpt2, lambda ps: FusedAdam(ps, lr=1e-4), 0)
    run("FusedLAMB, BERT-large", bert,
        lambda ps: FusedLAMB(ps, lr=1e-3, weight_decay=0.01), 1)
    run("FusedSGD, GPT-2 345M", gpt2,
        lambda ps: FusedSGD(ps, lr=0.03, momentum=0.9), 2,
        ("momentum_buffer",))
    run_o2 = [(tuple(p.shape),
               torch.float32 if is_norm_name(n) else torch.bfloat16)
              for n, p in gpt2_model.named_parameters()]
    unscale("multi_tensor_scale, GPT-2 345M O2 gradients", run_o2, 3)
    amp_steps("amp O2 FusedMixedPrecisionLamb, BERT-large",
              BertModel(TransformerConfig(
                  **BERT, attn_mask_type=AttnMaskType.padding),
                  device="cuda"), "O2",
              lambda ps: FusedMixedPrecisionLamb(ps, lr=1e-3,
                                                 weight_decay=0.01), 4)
    amp_steps("amp O1 FusedSGD, GPT-2 345M",
              GPTModel(TransformerConfig(**GPT2), device="cuda"), "O1",
              lambda ps: FusedSGD(ps, lr=0.03, momentum=0.9), 5)
    try:
        from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
    except ImportError:
        print("FusedNovoGrad, FusedAdagrad: skipped (not in this "
              "checkout)", flush=True)
        return 0
    run("FusedNovoGrad, GPT-2 345M", gpt2,
        lambda ps: FusedNovoGrad(ps, lr=0.01, weight_decay=0.001), 6,
        ("exp_avg",), ("exp_avg_sq",))
    run("FusedAdagrad, GPT-2 345M", gpt2,
        lambda ps: FusedAdagrad(ps, lr=1e-4), 7, ("sum",))
    return 0


if __name__ == "__main__":
    sys.exit(main())
