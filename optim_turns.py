"""Hashes of FusedAdam's and FusedLAMB's state after plain steps on the
card, for holding two checkouts' optimizer paths to each other bit for
bit.

From the root of a checkout (its ``apex_tpu_torch`` is the one
imported), on one NVIDIA GPU:

    python3 optim_turns.py

Four plain ``FusedAdam(lr=1e-4)`` steps over GPT-2 345M's 293 parameter
shapes (fp32) and four plain ``FusedLAMB(lr=1e-3, weight_decay=0.01)``
steps over BERT-large's 302, on seeded random parameters and gradients
(no amp, no ``found_inf``, no ``scale``). Prints one line a case: the
SHA-256 of every parameter, ``exp_avg`` and ``exp_avg_sq`` after the
steps, the step count, and the median device time of ``opt.step()``
over TIMED further steps (CUDA events around each step, gradients
unchanged). Run it in two checkouts in turns (A, B, B, A): equal hashes
mean the two paths give the same bits; compare times only within one
call.
"""

import hashlib
import statistics
import sys

import torch

sys.path.insert(0, ".")

from apex_tpu_torch.models import (  # noqa: E402
    BertModel,
    GPTModel,
    TransformerConfig,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB  # noqa: E402
from apex_tpu_torch.transformer.enums import AttnMaskType  # noqa: E402

STEPS = 4
TIMED = 7
WIDTH = dict(hidden_size=1024, num_layers=24, num_attention_heads=16,
             ffn_hidden_size=4096, max_position_embeddings=1024)
GPT2 = dict(WIDTH, vocab_size=50304)
BERT = dict(WIDTH, vocab_size=30528, max_position_embeddings=512)


def _shapes(model):
    return [tuple(p.shape) for p in model.parameters()]


def run(label, shapes, make_opt, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.nn.Parameter(
        0.02 * torch.randn(s, generator=gen, device="cuda")) for s in shapes]
    opt = make_opt(params)
    for _ in range(STEPS):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        opt.step()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for p in params:
        state = opt.state[p]
        for t in (p.detach(), state["exp_avg"], state["exp_avg_sq"]):
            digest.update(t.contiguous().view(torch.int32).cpu().numpy()
                          .tobytes())
    step = int(torch.as_tensor(opt.param_groups[0]["step"]).reshape(-1)[0])
    times = []
    for _ in range(TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        opt.step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"{label}: {len(shapes)} tensors, {sum(p.numel() for p in params)} "
          f"params, step {step}: sha256 {digest.hexdigest()}; opt.step() "
          f"median {statistics.median(times):.3f} ms over {TIMED}",
          flush=True)
    del params, opt
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("optim_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpt2 = _shapes(GPTModel(TransformerConfig(**GPT2), device="meta"))
    bert = _shapes(BertModel(TransformerConfig(
        **BERT, attn_mask_type=AttnMaskType.padding), device="meta"))
    run("FusedAdam, GPT-2 345M", gpt2, lambda ps: FusedAdam(ps, lr=1e-4), 0)
    run("FusedLAMB, BERT-large", bert,
        lambda ps: FusedLAMB(ps, lr=1e-3, weight_decay=0.01), 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
