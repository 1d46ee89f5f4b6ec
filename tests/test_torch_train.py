"""apex_tpu_torch's training step (GPTModel's training forward,
gpt_loss_fn, backward, FusedAdam) against apex_tpu's on the CPU: the
slice as a whole.

Small Llama-shaped model (hidden 64, 2 layers, 4 heads, 2 KV groups,
vocab 256, swiglu, rmsnorm, rope) with ``use_flash_attention=False``,
seq 32, batch 2; and with ``use_flash_attention=True`` (head dim 64, seq
128, GQA or MHA, with and without a 40-position sliding window), where
the JAX model takes its flash branch with the Pallas kernels in
interpret mode (``_flash_available`` and ``fmha._use_pallas`` patched
true, as the JAX suite does: its own test asks for a TPU backend) and
the port its flash branch through the kernels' plain versions. The JAX model is initialised from a PRNG key and its
params go to the port through ``from_jax_params``; tokens and labels
come from a numpy seed. The JAX side is
``jax.value_and_grad(lambda p: gpt_loss_fn(model.apply({"params": p},
tokens), labels))`` and ``FusedAdam.step``, with its RMSNorm and softmax
kernels in Pallas interpret mode.

The bf16 reference runs op by op (not under ``jax.jit``): XLA's CPU
compiler keeps excess precision across the model's fp32 -> bf16 -> fp32
round trips under jit, so the jitted model is not the bf16 arithmetic
written in the JAX code; op by op it is, and the port follows it.

Tolerances (relative errors are Frobenius norms; "update" is a
parameter's change over the steps taken):
- fp32 ``compute_dtype``: loss within 1e-6 relative; every gradient
  within 1e-5 (measured ~1e-6: the same fp32 arithmetic, summed in
  another order); every parameter's update after each of two steps
  within 1e-3 (measured <= 1.7e-4: Adam divides each gradient by its
  own magnitude, so an entry whose gradient is ~0 moves by +-lr on a
  difference of one ulp).
- bf16 ``compute_dtype``: loss within 2e-4 relative (measured <= 6e-5);
  every gradient within 1e-2 (measured up to 1.3e-3: where an fp32 sum
  in another order puts a value across a bf16 rounding boundary, the
  one-ulp difference, 2**-8 relative, flows back through the earlier
  layers); the update of all parameters together within 5e-2 (measured
  1.2e-2), and of each parameter within 0.5: Adam's first steps are
  sign-like, so the few entries of a small tensor whose gradients are
  near 0 may move by +-lr on either side (measured up to 0.17 for a
  64-entry bias), while a wrong or missing update is off by 1 or more.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.fmha as jax_fmha
import apex_tpu.models.transformer_lm as jax_tlm
from apex_tpu.kernels import softmax as _jax_softmax  # noqa: F401 (gate)
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy as jax_cross_entropy,
)
from apex_tpu_torch.contrib import fmha
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    from_jax_params,
    gpt_loss_fn,
    init_cache,
    init_weights,
    load_jax_optimizer_state,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          num_query_groups=2, ffn_hidden_size=128, vocab_size=256,
          max_position_embeddings=128, normalization="rmsnorm",
          position_embedding_type="rope", activation="swiglu")
BATCH, SEQ, LR, STEPS = 2, 32, 1e-3, 2
FLASH_SEQ = 128
# (num_query_groups, sliding_window) of the flash cases
FLASH = {"gqa": (2, None), "gqa-window40": (2, 40), "mha": (None, None),
         "mha-window40": (None, 40)}
TOL = {"float32": dict(loss=1e-6, grad=1e-5, update=1e-3, total=1e-3),
       "bfloat16": dict(loss=2e-4, grad=1e-2, update=0.5, total=5e-2)}
# the flash cases' model (head dim 64, seq 128) in bf16: more entries per
# tensor and more tokens per gradient than the flash-off model above,
# so more entries with near-zero gradients whose sign can flip (measured
# total 0.070 with flash off at this size, 0.073-0.082 with flash on; a
# share f of flipped entries gives 2 * sqrt(f), f ~ 1.4e-3)
FLASH_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(TOL["bfloat16"], total=0.15)}
_KERNELS = ["softmax", "rmsnorm", "adam"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, _KERNELS)
    monkeypatch.setattr(jax_fmha, "_INTERPRET", True)
    monkeypatch.setattr(jax_fmha, "_use_pallas", lambda: True)
    monkeypatch.setattr(jax_tlm, "_flash_available", lambda s, d: True)
    yield
    reg.force_interpret(False, _KERNELS)


def _batch(seed=0, seq=SEQ):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(BATCH, seq)),
            rng.randint(0, 256, size=(BATCH, seq)))


def _kw(flash):
    """Config fields (and the sequence) of the flash-off model, or of a
    flash case of FLASH."""
    if flash is None:
        return dict(KW, use_flash_attention=False), SEQ
    groups, window = FLASH[flash]
    return dict(KW, use_flash_attention=True, head_dim=64,
                num_query_groups=groups, sliding_window=window), FLASH_SEQ


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _reference(dtype, flash=None):
    """The JAX side's initial params and, for each step, its loss, grads,
    params after the update and optimizer state (numpy trees); built
    once per dtype and model."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kw, seq = _kw(flash)
    model = JaxGPTModel(JaxConfig(**kw, compute_dtype=jdt))
    tokens, labels = (jnp.asarray(a) for a in _batch(seq=seq))
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    opt = JaxFusedAdam(lr=LR)

    def step(p, s):
        loss, grads = jax.value_and_grad(
            lambda q: jax_gpt_loss_fn(model.apply({"params": q}, tokens),
                                      labels))(p)
        new_p, new_s = opt.step(grads, s, p)
        return loss, grads, new_p, new_s

    if dtype == "float32":
        step = jax.jit(step)
    out, p, s = [], params, opt.init(params)
    for _ in range(STEPS):
        loss, grads, p, s = step(p, s)
        out.append(dict(loss=float(loss), grads=_np_tree(grads),
                        params=_np_tree(p), state=jax.tree.map(np.asarray,
                                                               s)))
    return _np_tree(params), out


def _port_model(dtype, params, flash=None):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cfg = TransformerConfig(**_kw(flash)[0], compute_dtype=tdt)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg))
    return model


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _assert_updates(model, before, want_after, tol, what):
    """Each parameter's update (after - before) within ``tol["update"]``
    relative of the JAX update, and all of them together within
    ``tol["total"]``."""
    after = {n: p.detach().float().numpy()
             for n, p in model.named_parameters()}
    want = {n: t.numpy() - before[n]
            for n, t in from_jax_params(want_after).items()}
    errs = {n: _rel(after[n] - before[n], want[n]) for n in after}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["update"], (what, worst, errs[worst])
    diff = np.sqrt(sum(np.sum((after[n] - before[n] - want[n]) ** 2)
                       for n in after))
    total = diff / np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert total <= tol["total"], (what, total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_jax(dtype):
    params, steps = _reference(dtype)
    model = _port_model(dtype, params)
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    logits = model(tokens)
    assert logits.dtype == torch.float32
    assert logits.shape == (BATCH, SEQ, KW["vocab_size"])
    loss = gpt_loss_fn(logits, labels)
    loss.backward()
    tol = TOL[dtype]
    assert abs(loss.item() - steps[0]["loss"]) <= tol["loss"] * abs(
        steps[0]["loss"])
    want = from_jax_params(steps[0]["grads"])
    grads = dict(model.named_parameters())
    assert grads.keys() == want.keys()
    for name, p in grads.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        err = _rel(p.grad.numpy(), want[name].numpy())
        assert err <= tol["grad"], (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_fused_adam_steps_match_jax(dtype):
    params, steps = _reference(dtype)
    model = _port_model(dtype, params)
    opt = FusedAdam(model.parameters(), lr=LR)
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    before = from_jax_params(params)
    before = {n: t.numpy() for n, t in before.items()}
    for k in range(STEPS):
        loss = gpt_loss_fn(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.zero_grad()
        assert abs(loss.item() - steps[k]["loss"]) <= TOL[dtype]["loss"] * abs(
            steps[k]["loss"]), (k, loss.item(), steps[k]["loss"])
        _assert_updates(model, before, steps[k]["params"], TOL[dtype],
                        f"step {k + 1}")
    assert opt.param_groups[0]["step"] == STEPS


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the port's flash forwards (plain versions on the CPU)."""
    calls = []
    plain = fmha.flash_fwd_plain

    def counted(*args, **kwargs):
        calls.append(args[4:6])  # causal, window
        return plain(*args, **kwargs)

    monkeypatch.setattr(fmha, "flash_fwd_plain", counted)
    return calls


@pytest.mark.parametrize("flash", list(FLASH))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_loss_and_every_gradient_match_jax(dtype, flash, flash_calls):
    params, steps = _reference(dtype, flash)
    model = _port_model(dtype, params, flash)
    tokens, labels = (torch.from_numpy(a) for a in _batch(seq=FLASH_SEQ))
    loss = gpt_loss_fn(model(tokens), labels)
    loss.backward()
    window = FLASH[flash][1]
    assert flash_calls == [(True, window)] * KW["num_layers"]
    tol = TOL[dtype]
    assert abs(loss.item() - steps[0]["loss"]) <= tol["loss"] * abs(
        steps[0]["loss"]), (loss.item(), steps[0]["loss"])
    want = from_jax_params(steps[0]["grads"])
    for name, p in model.named_parameters():
        err = _rel(p.grad.numpy(), want[name].numpy())
        assert err <= tol["grad"], (name, err)


@pytest.mark.parametrize("flash", ["gqa-window40", "mha"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_two_fused_adam_steps_match_jax(dtype, flash):
    params, steps = _reference(dtype, flash)
    model = _port_model(dtype, params, flash)
    opt = FusedAdam(model.parameters(), lr=LR)
    tokens, labels = (torch.from_numpy(a) for a in _batch(seq=FLASH_SEQ))
    before = {n: t.numpy() for n, t in from_jax_params(params).items()}
    for k in range(STEPS):
        loss = gpt_loss_fn(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.zero_grad()
        assert abs(loss.item() - steps[k]["loss"]) <= TOL[dtype]["loss"] * abs(
            steps[k]["loss"]), (k, loss.item(), steps[k]["loss"])
        _assert_updates(model, before, steps[k]["params"], FLASH_TOL[dtype],
                        f"step {k + 1}")


def test_second_step_from_the_jax_state_matches_jax():
    """The port's model and optimizer started from the JAX params and
    FusedAdam state after step 1 take JAX's step 2 (fp32)."""
    params, steps = _reference("float32")
    model = _port_model("float32", steps[0]["params"])
    opt = FusedAdam(model.parameters(), lr=LR)
    load_jax_optimizer_state(opt, model, steps[0]["state"])
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    loss = gpt_loss_fn(model(tokens), labels)
    loss.backward()
    opt.step()
    assert abs(loss.item() - steps[1]["loss"]) <= 1e-6 * abs(steps[1]["loss"])
    before = {n: t.numpy() for n, t in from_jax_params(
        steps[0]["params"]).items()}
    _assert_updates(model, before, steps[1]["params"], TOL["float32"],
                    "step 2")


def test_loss_mask_and_label_smoothing_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 5, 16).astype(np.float32) * 3
    labels = rng.randint(0, 16, size=(2, 5))
    mask = (rng.rand(2, 5) > 0.4).astype(np.float32)
    want = jax_gpt_loss_fn(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(mask))
    got = gpt_loss_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want_ls = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                label_smoothing=0.1)
    got_ls = vocab_parallel_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels), 0.1)
    np.testing.assert_allclose(got_ls.numpy(), np.asarray(want_ls),
                               rtol=1e-6, atol=1e-6)
    # the gradient is softmax minus one-hot, over the token count
    x = torch.from_numpy(logits).requires_grad_()
    gpt_loss_fn(x, torch.from_numpy(labels)).backward()
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels), 16)
    torch.testing.assert_close(
        x.grad, (torch.softmax(x.detach(), -1) - onehot) / 10, rtol=1e-5,
        atol=1e-7)


def test_training_step_on_plain_versions_counts_no_launch():
    params, _ = _reference("float32")
    model = _port_model("float32", params)
    registry.reset()
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    gpt_loss_fn(model(tokens), labels).backward()
    FusedAdam(model.parameters()).step()
    assert not any(registry.launches().values()), registry.launches()


def _tiny(**over):
    cfg = TransformerConfig(**{**KW, "num_layers": 1,
                               "use_flash_attention": False, **over})
    return GPTModel(cfg, device="cpu")


@pytest.mark.parametrize("over,match", [
    # ALiBi positions are not ported yet; a window needs causal attention
    # (JAX's check); an unknown normalization
    (dict(position_embedding_type="alibi"), "alibi"),
    (dict(sliding_window=8, attn_mask_type=AttnMaskType.padding), "causal"),
    (dict(normalization="batchnorm"), "normalization"),
])
def test_training_forward_refuses_what_it_cannot_run(over, match):
    tokens = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _tiny(**over)(tokens)


def test_training_forward_refuses_an_attention_mask():
    """An attention_mask that does not broadcast to the [b, n, s, s]
    scores is refused (one that does runs the masked softmax path)."""
    tokens = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="broadcast"):
        _tiny()(tokens, attention_mask=torch.zeros(1, 1, 16, 8,
                                                   dtype=torch.bool))


# the softmax path's other branches: (config fields, attention mask kind)
SOFTMAX_PATH = {
    "window": (dict(sliding_window=8), None),
    "padding-type": (dict(attn_mask_type=AttnMaskType.padding), None),
    "padding-mask": (dict(attn_mask_type=AttnMaskType.padding), "pad"),
    "causal-mask": (dict(), "random"),
    "window-mask": (dict(sliding_window=8), "random"),
}


def _attention_mask(kind, seq):
    """A [b, 1, s, s] bool mask (True = masked): key padding of the last
    3 keys of row 1, or random with the diagonal kept; None for None."""
    if kind is None:
        return None
    if kind == "pad":
        keep = np.ones((BATCH, seq), bool)
        keep[1, -3:] = False
        return ~(keep[:, None, None, :] & np.ones((BATCH, 1, seq, 1), bool))
    m = np.random.RandomState(seq).rand(BATCH, 1, seq, seq) < 0.3
    m[..., np.arange(seq), np.arange(seq)] = False
    return m


@pytest.mark.parametrize("case", list(SOFTMAX_PATH))
def test_softmax_path_masks_and_windows_match_jax(case):
    """The flash-off training forward with a window folded into the mask,
    the padding mask type (scaled softmax without a mask, masked softmax
    with one) and explicit masks: loss and every gradient against the JAX
    model's (fp32, its softmax kernels interpreted), within the fp32
    tolerances above."""
    over, kind = SOFTMAX_PATH[case]
    kw = dict(KW, use_flash_attention=False, **over)
    model_j = JaxGPTModel(JaxConfig(**kw, compute_dtype=jnp.float32))
    tokens, labels = _batch()
    mask = _attention_mask(kind, SEQ)
    jmask = None if mask is None else jnp.asarray(mask)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(tokens))[
        "params"]
    loss_j, grads_j = jax.value_and_grad(lambda p: jax_gpt_loss_fn(
        model_j.apply({"params": p}, jnp.asarray(tokens),
                      attention_mask=jmask), jnp.asarray(labels)))(params)
    cfg = TransformerConfig(**kw, compute_dtype=torch.float32)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(_np_tree(params), cfg))
    loss = gpt_loss_fn(model(torch.from_numpy(tokens), attention_mask=(
        None if mask is None else torch.from_numpy(mask))),
        torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    want = from_jax_params(_np_tree(grads_j))
    for name, p in model.named_parameters():
        err = _rel(p.grad.numpy(), want[name].numpy())
        assert err <= TOL["float32"]["grad"], (name, err)


def test_window_covering_the_sequence_is_plain_causal():
    """As in the JAX model, a window no shorter than the sequence masks
    nothing more than causality."""
    tokens = torch.from_numpy(_batch()[0][:, :16])
    a = _tiny(sliding_window=16)
    init_weights(a, 0)
    b = _tiny()
    b.load_state_dict(a.state_dict())
    torch.testing.assert_close(a(tokens), b(tokens), rtol=0, atol=0)


def test_decode_refuses_an_attention_mask():
    """As in the JAX model, the KV-cache path takes no attention_mask."""
    model = _tiny()
    init_weights(model, 0)
    cache = init_cache(model, 1)
    with pytest.raises(ValueError, match="attention_mask"):
        model(torch.zeros(1, 4, dtype=torch.long), None, cache,
              attention_mask=torch.zeros(1, 1, 4, 4, dtype=torch.bool))


@pytest.mark.parametrize("over,seq", [
    (dict(), 16),                               # seq not a multiple of 128
    (dict(head_dim=None), 128),                 # head dim 16
    (dict(attn_logit_softcapping=30.0), 128),   # softcap
    (dict(query_pre_attn_scalar=32.0), 128),    # another score scale
])
def test_flash_is_taken_only_under_the_jax_condition(over, seq, flash_calls):
    """Otherwise the softmax path runs, as the JAX model's does; its
    output equals the flash-off model's."""
    cfg = {**KW, "num_layers": 1, "head_dim": 64, **over}
    a = GPTModel(TransformerConfig(**cfg, use_flash_attention=True),
                 device="cpu")
    init_weights(a, 0)
    b = GPTModel(TransformerConfig(**cfg, use_flash_attention=False),
                 device="cpu")
    b.load_state_dict(a.state_dict())
    tokens = torch.from_numpy(_batch(seq=seq)[0])
    torch.testing.assert_close(a(tokens), b(tokens), rtol=0, atol=0)
    assert flash_calls == []


def test_flash_runs_the_padding_mask_type_as_full_attention(flash_calls):
    """attn_mask_type padding without a mask: flash with causal=False (as
    in JAX; flash off takes the scaled softmax kernel)."""
    cfg = TransformerConfig(**dict(KW, num_layers=1, head_dim=64),
                            attn_mask_type=AttnMaskType.padding)
    model = GPTModel(cfg, device="cpu")
    init_weights(model, 0)
    tokens = torch.from_numpy(_batch(seq=FLASH_SEQ)[0])
    logits = model(tokens)
    assert torch.isfinite(logits).all()
    assert flash_calls == [(False, None)]
