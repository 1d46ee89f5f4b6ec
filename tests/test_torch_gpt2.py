"""apex_tpu_torch's GPT-2-shaped model (learned positions, LayerNorm,
gelu with biases, tied or untied head) against apex_tpu's on the CPU:
the training step (loss, every gradient, two ``FusedAdam`` updates) with
flash attention off and on, greedy ``generate``, the ``TransformerConfig``
defaults, and the parameter trees.

Small GPT-2-shaped model (hidden 64, 2 layers, 4 heads, vocab 256, max
positions 128, the ``TransformerConfig`` defaults otherwise) with
``use_flash_attention=False`` at seq 32, batch 2; and with
``use_flash_attention=True`` at head dim 64, seq 128, where the JAX
model takes its flash branch with the Pallas kernels in interpret mode
(``_flash_available`` and ``fmha._use_pallas`` patched true, as the
JAX suite does: its own test asks for a TPU backend) and the port its
flash branch through the kernels' plain versions. The JAX model is
initialised from a PRNG key and its params go to the port through
``from_jax_params``; tokens and labels come from a numpy seed. The JAX
side runs its LayerNorm and softmax kernels in Pallas interpret mode;
the bf16 reference runs op by op (not under ``jax.jit``: under jit XLA's
CPU compiler keeps excess precision across fp32 -> bf16 -> fp32 round
trips).

Tolerances (relative errors are Frobenius norms; "update" is a
parameter's change over the steps taken), those of the Llama-shaped
step in ``tests/test_torch_train.py``, for the same reasons:
- fp32: loss within 1e-6 relative, every gradient within 1e-5, every
  update within 1e-3 (Adam moves an entry whose gradient is ~0 by
  +-lr on a difference of one ulp). The per-tensor check leaves out the
  entries whose step-1 gradient is below 1e-6 of their tensor's largest:
  the key third of the QKV bias, whose gradient is zero in exact
  arithmetic (a key bias shifts every score of a row by one amount,
  which the softmax cancels), holds only rounding noise that Adam scales
  up to a good share of +-lr (measured: 2.4e-2 of that bias's update
  with them); the total over all parameters keeps them.
- bf16: loss within 2e-4, every gradient within 1e-2 (one-ulp bf16
  roundings of the residual stream, 2**-8 relative, flow back through
  the earlier layers), the update of all parameters together within
  5e-2 (0.15 with flash at seq 128: more near-zero gradients whose sign
  can flip), each parameter's within 0.5 (Adam's first steps are
  sign-like; a wrong or missing update is off by 1 or more).
Greedy tokens of the fp32 model are compared for equality.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib.fmha as jax_fmha
import apex_tpu.models.transformer_lm as jax_tlm
from apex_tpu.contrib import gqa_decode as jax_gqa
from apex_tpu.kernels import fused_cc as _jax_fused_cc  # noqa: F401 (gate)
from apex_tpu.kernels import norm as _jax_norm  # noqa: F401 (gate)
from apex_tpu.kernels import softmax as _jax_softmax  # noqa: F401 (gate)
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import generation as jax_gen
from apex_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.transformer import parallel_state
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    from_jax_params,
    generate,
    gpt_loss_fn,
    init_weights,
)
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.optimizers import FusedAdam
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=256, max_position_embeddings=128)
BATCH, SEQ, LR, STEPS = 2, 32, 1e-3, 2
FLASH_SEQ = 128
TOL = {"float32": dict(loss=1e-6, grad=1e-5, update=1e-3, total=1e-3),
       "bfloat16": dict(loss=2e-4, grad=1e-2, update=0.5, total=5e-2)}
FLASH_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(TOL["bfloat16"], total=0.15)}
_KERNELS = ["softmax", "layernorm"]


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


def _kw(flash, tie):
    kw = dict(KW, tie_word_embeddings=tie, use_flash_attention=flash)
    if flash:
        kw["head_dim"] = 64
    return kw, (FLASH_SEQ if flash else SEQ)


def _batch(seq, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(BATCH, seq)),
            rng.randint(0, 256, size=(BATCH, seq)))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _reference(dtype, flash, tie):
    """The JAX side's initial params and, for each step, its loss, grads
    and params after the update (numpy trees)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kw, seq = _kw(flash, tie)
    model = JaxGPTModel(JaxConfig(**kw, compute_dtype=jdt))
    tokens, labels = (jnp.asarray(a) for a in _batch(seq))
    params = model.init(jax.random.PRNGKey(1), tokens)["params"]
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
                        params=_np_tree(p)))
    return _np_tree(params), out


def _port_model(dtype, params, flash, tie):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cfg = TransformerConfig(**_kw(flash, tie)[0], compute_dtype=tdt)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg))
    return model


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


CASES = [(flash, tie) for flash in (False, True) for tie in (False, True)]


@pytest.mark.parametrize("flash,tie", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt2_loss_and_every_gradient_match_jax(dtype, flash, tie):
    params, steps = _reference(dtype, flash, tie)
    model = _port_model(dtype, params, flash, tie)
    assert isinstance(model.final_layernorm, FusedLayerNorm)
    tokens, labels = (torch.from_numpy(a) for a in _batch(_kw(flash, tie)[1]))
    logits = model(tokens)
    assert logits.dtype == torch.float32
    loss = gpt_loss_fn(logits, labels)
    loss.backward()
    tol = TOL[dtype]
    assert abs(loss.item() - steps[0]["loss"]) <= tol["loss"] * abs(
        steps[0]["loss"]), (loss.item(), steps[0]["loss"])
    want = from_jax_params(steps[0]["grads"])
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    assert "position_embeddings" in named
    assert ("lm_head" in named) == (not tie)
    for name, p in named.items():
        err = _rel(p.grad.numpy(), want[name].numpy())
        assert err <= tol["grad"], (name, err)


@pytest.mark.parametrize("flash,tie", [(False, False), (True, False),
                                       (False, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt2_two_fused_adam_steps_match_jax(dtype, flash, tie):
    params, steps = _reference(dtype, flash, tie)
    model = _port_model(dtype, params, flash, tie)
    opt = FusedAdam(model.parameters(), lr=LR)
    tokens, labels = (torch.from_numpy(a) for a in _batch(_kw(flash, tie)[1]))
    before = {n: t.numpy() for n, t in from_jax_params(params).items()}
    g1 = {n: np.abs(t.numpy())
          for n, t in from_jax_params(steps[0]["grads"]).items()}
    live = {n: g > 1e-6 * g.max() for n, g in g1.items()}
    tol = (FLASH_TOL if flash else TOL)[dtype]
    for k in range(STEPS):
        loss = gpt_loss_fn(model(tokens), labels)
        loss.backward()
        opt.step()
        opt.zero_grad()
        assert abs(loss.item() - steps[k]["loss"]) <= tol["loss"] * abs(
            steps[k]["loss"]), (k, loss.item(), steps[k]["loss"])
        after = {n: p.detach().float().numpy()
                 for n, p in model.named_parameters()}
        want = {n: t.numpy() - before[n]
                for n, t in from_jax_params(steps[k]["params"]).items()}
        errs = {n: _rel((after[n] - before[n])[live[n]], want[n][live[n]])
                for n in after}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tol["update"], (k, worst, errs[worst])
        diff = np.sqrt(sum(np.sum((after[n] - before[n] - want[n]) ** 2)
                           for n in after))
        total = diff / np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
        assert total <= tol["total"], (k, total)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("plen,new", [(7, 5), (1, 4)])
def test_gpt2_generate_greedy_tokens_match_jax(tie, plen, new):
    """Learned positions at absolute positions through the KV cache: the
    port's generate against JAX's (fp32, decode kernels interpreted)."""
    kw = dict(KW, tie_word_embeddings=tie, use_flash_attention=False)
    reg = get_kernel_registry()
    reg.force_interpret(True, ["fused_cc"])
    jax_gqa.force_interpret(True)
    try:
        model_j = JaxGPTModel(JaxConfig(**kw, compute_dtype=jnp.float32),
                              decode=True)
        params = model_j.init(jax.random.PRNGKey(2),
                              jnp.zeros((1, 4), jnp.int32))["params"]
        prompt = np.random.RandomState(plen).randint(0, 256, size=(2, plen))
        want = np.asarray(jax_gen.generate(model_j, params,
                                           jnp.asarray(prompt), new))
    finally:
        jax_gqa.force_interpret(False)
        reg.force_interpret(False, ["fused_cc"])
    cfg = TransformerConfig(**kw, compute_dtype=torch.float32)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    got = generate(model, torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transformer_config_defaults_match_jax():
    """Built with no arguments, the two packages' configs agree on every
    field the port has (the GPT-2 family: learned positions, gelu,
    LayerNorm, untied head)."""
    port = TransformerConfig()
    jax_cfg = JaxConfig()
    dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for field in dataclasses.fields(port):
        got = getattr(port, field.name)
        want = getattr(jax_cfg, field.name)
        if isinstance(got, torch.dtype):
            assert dtypes[got] == want, field.name
        elif field.name == "attn_mask_type":
            assert got.name == want.name
        else:
            assert got == want, (field.name, got, want)
    assert (port.position_embedding_type, port.activation,
            port.normalization) == ("learned", "gelu", "layernorm")


def test_gpt2_parameters_keep_the_jax_names_and_shapes():
    for tie in (False, True):
        kw = dict(KW, tie_word_embeddings=tie)
        tree = JaxGPTModel(JaxConfig(**kw)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        want = {k: tuple(v.shape) for k, v in from_jax_params(
            jax.tree.map(np.asarray, tree)).items()}
        got = {k: tuple(v.shape) for k, v in GPTModel(
            TransformerConfig(**kw), device="cpu").named_parameters()}
        assert got == want


def test_init_weights_draws_positions_like_the_jax_initialiser():
    """position_embeddings ~ N(0, 0.02), as JAX's normal(0.02), not the
    fan-in scale of a [1024, 64] matrix (0.031); LayerNorm weights 1 and
    biases 0."""
    model = GPTModel(TransformerConfig(**dict(
        KW, max_position_embeddings=1024)), device="cpu")
    init_weights(model, 0)
    named = dict(model.named_parameters())
    # 65,536 draws: the sample std within 2 % of 0.02 (~5 standard errors)
    for name in ("position_embeddings", "word_embeddings.weight", "lm_head"):
        assert abs(named[name].std().item() - 0.02) < 4e-4, name
    norm = model.transformer.layers[0].input_layernorm
    assert torch.equal(norm.weight, torch.ones(64))
    assert torch.equal(norm.bias, torch.zeros(64))


def test_gpt2_step_on_plain_versions_counts_no_launch():
    params, _ = _reference("float32", False, False)
    model = _port_model("float32", params, False, False)
    registry.reset()
    tokens, labels = (torch.from_numpy(a) for a in _batch(SEQ))
    gpt_loss_fn(model(tokens), labels).backward()
    FusedAdam(model.parameters()).step()
    assert not any(registry.launches().values()), registry.launches()
