"""apex_tpu_torch's BertModel, bert_loss_fn and FusedLAMB against
apex_tpu's on the CPU: the BERT pretraining step (MLM + NSP loss, every
gradient, two ``FusedLAMB`` updates), the padded case in which both
packages give NaN, and the parameter tree.

Small BERT-shaped model (hidden 64, 2 layers, 4 heads, vocab 256, 64
positions, ``AttnMaskType.padding``, flash off) on a batch of 2 x 32
tokens with an all-ones padding mask, token types 0 and 1, a 15 % loss
mask and NSP labels, all from a numpy seed. The JAX model is initialised
from a PRNG key (with token types, so it has ``tokentype_embeddings``)
and its params go to the port through ``from_jax_params``. The JAX side
runs its masked softmax and LayerNorm kernels in Pallas interpret mode;
the bf16 reference runs op by op (not under ``jax.jit``).

Tolerances (relative Frobenius errors; "update" is a parameter's change
over the steps taken):
- fp32: loss within 1e-6 relative, every gradient within 1e-5 (the same
  fp32 arithmetic, summed in another order), every update within 1e-3
  and all of them together within 1e-3. LAMB's first update is u =
  h / (|h| + eps) + wd * p with h the clipped gradient, sign-like where
  |h| >> eps = 1e-6, so an entry whose gradient is ~0 moves by up to
  +-lr * ratio on a difference of one ulp: the per-tensor check leaves
  out the entries whose step-1 gradient is below 1e-6 of their tensor's
  largest (the key third of the QKV bias, zero in exact arithmetic: a
  key bias shifts a row's scores by one amount, which the softmax
  cancels); the total keeps them.
- bf16: loss within 2e-4, every gradient within 1e-2, the update of all
  parameters together within 5e-2 and of each within 0.5, as for Adam
  in ``tests/test_torch_train.py`` and for the same reason: the signs of
  near-zero gradients may flip after one-ulp bf16 roundings.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import norm as _jax_norm  # noqa: F401 (gate)
from apex_tpu.kernels import softmax as _jax_softmax  # noqa: F401 (gate)
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import bert_loss_fn as jax_bert_loss_fn
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models import (
    BertModel,
    TransformerConfig,
    bert_loss_fn,
    from_jax_params,
    init_weights,
)
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.transformer.enums import AttnMaskType

KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
          vocab_size=256, max_position_embeddings=64,
          use_flash_attention=False)
BATCH, SEQ, STEPS = 2, 32, 2
LAMB = dict(lr=1e-3, weight_decay=0.01)
TOL = {"float32": dict(loss=1e-6, grad=1e-5, update=1e-3, total=1e-3),
       "bfloat16": dict(loss=2e-4, grad=1e-2, update=0.5, total=5e-2)}
_KERNELS = ["softmax", "layernorm"]


@pytest.fixture(autouse=True)
def _interpret():
    parallel_state.destroy_model_parallel()
    reg = get_kernel_registry()
    reg.force_interpret(True, _KERNELS)
    yield
    reg.force_interpret(False, _KERNELS)


def _inputs(padded=False, seed=0):
    """tokens, padding mask (1 = keep), token types, labels, loss mask,
    NSP labels; with ``padded`` the last 5 positions of row 1 are
    padding."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 256, size=(BATCH, SEQ))
    padding = np.ones((BATCH, SEQ), np.int32)
    if padded:
        padding[1, -5:] = 0
    tokentype = (rng.rand(BATCH, SEQ) < 0.5).astype(np.int32)
    labels = rng.randint(0, 256, size=(BATCH, SEQ))
    loss_mask = (rng.rand(BATCH, SEQ) < 0.15).astype(np.float32)
    nsp = rng.randint(0, 2, size=(BATCH,))
    return tokens, padding, tokentype, labels, loss_mask, nsp


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return JaxBertModel(JaxConfig(**KW, compute_dtype=jdt,
                                  attn_mask_type=JaxMaskType.padding))


@functools.lru_cache(maxsize=None)
def _reference(dtype):
    """The JAX side's initial params and, for each step, its loss, grads
    and params after the FusedLAMB update (numpy trees)."""
    model = _jax_model(dtype)
    tokens, padding, tokentype, labels, loss_mask, nsp = (
        jnp.asarray(a) for a in _inputs())
    params = model.init(jax.random.PRNGKey(3), tokens, padding,
                        tokentype)["params"]
    opt = JaxFusedLAMB(**LAMB)

    def step(p, s):
        def loss_fn(q):
            mlm, nsp_logits = model.apply({"params": q}, tokens, padding,
                                          tokentype)
            return jax_bert_loss_fn(mlm, nsp_logits, labels, loss_mask, nsp)
        loss, grads = jax.value_and_grad(loss_fn)(p)
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


def _port_model(dtype, params):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cfg = TransformerConfig(**KW, compute_dtype=tdt,
                            attn_mask_type=AttnMaskType.padding)
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg))
    return model


def _port_loss(model, inputs):
    tokens, padding, tokentype, labels, loss_mask, nsp = (
        torch.from_numpy(a) for a in inputs)
    mlm, nsp_logits = model(tokens, padding, tokentype)
    return bert_loss_fn(mlm, nsp_logits, labels, loss_mask, nsp)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_loss_and_every_gradient_match_jax(dtype):
    params, steps = _reference(dtype)
    model = _port_model(dtype, params)
    tokens, padding, tokentype = (torch.from_numpy(a)
                                  for a in _inputs()[:3])
    mlm, nsp = model(tokens, padding, tokentype)
    assert mlm.dtype == torch.float32 and mlm.shape == (BATCH, SEQ, 256)
    assert nsp.dtype == torch.float32 and nsp.shape == (BATCH, 2)
    loss = _port_loss(model, _inputs())
    loss.backward()
    tol = TOL[dtype]
    assert abs(loss.item() - steps[0]["loss"]) <= tol["loss"] * abs(
        steps[0]["loss"]), (loss.item(), steps[0]["loss"])
    want = from_jax_params(steps[0]["grads"])
    named = dict(model.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        err = _rel(p.grad.numpy(), want[name].numpy())
        assert err <= tol["grad"], (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_two_fused_lamb_steps_match_jax(dtype):
    params, steps = _reference(dtype)
    model = _port_model(dtype, params)
    opt = FusedLAMB(model.parameters(), **LAMB)
    before = {n: t.numpy() for n, t in from_jax_params(params).items()}
    g1 = {n: np.abs(t.numpy())
          for n, t in from_jax_params(steps[0]["grads"]).items()}
    live = {n: g > 1e-6 * g.max() for n, g in g1.items()}
    tol = TOL[dtype]
    for k in range(STEPS):
        loss = _port_loss(model, _inputs())
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
    assert opt.param_groups[0]["step"] == STEPS


def test_padded_sequence_gives_nan_in_both_packages():
    """A padded position's query row has every key masked; the masked
    softmax gives that row 0 / 0 = NaN in JAX's oracle and kernel, and
    the port reproduces it: the loss is NaN on both sides (a
    reference-side behaviour, recorded in ROADMAP queue C)."""
    params, _ = _reference("float32")
    inputs = _inputs(padded=True)
    model_j = _jax_model("float32")
    tokens, padding, tokentype, labels, loss_mask, nsp = (
        jnp.asarray(a) for a in inputs)
    mlm, nsp_logits = model_j.apply({"params": params}, tokens, padding,
                                    tokentype)
    want = float(jax_bert_loss_fn(mlm, nsp_logits, labels, loss_mask, nsp))
    got = _port_loss(_port_model("float32", params), inputs).item()
    assert np.isnan(want) and np.isnan(got)
    # without padding both are finite
    assert np.isfinite(_port_loss(_port_model("float32", params),
                                  _inputs()).item())


def test_no_padding_mask_takes_the_scaled_softmax_and_matches_all_ones():
    """padding_mask None: the padding mask type with no mask (JAX's
    scaled_softmax); nothing masked, so the same logits as the all-ones
    mask."""
    params, _ = _reference("float32")
    model = _port_model("float32", params)
    tokens, padding, tokentype = (torch.from_numpy(a)
                                  for a in _inputs()[:3])
    mlm_none, nsp_none = model(tokens, None, tokentype)
    mlm_ones, nsp_ones = model(tokens, padding, tokentype)
    torch.testing.assert_close(mlm_none, mlm_ones, rtol=0, atol=0)
    torch.testing.assert_close(nsp_none, nsp_ones, rtol=0, atol=0)
    model_j = _jax_model("float32")
    want, _ = model_j.apply({"params": params}, jnp.asarray(tokens.numpy()),
                            None, jnp.asarray(tokentype.numpy()))
    np.testing.assert_allclose(mlm_none.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_lamb_overshoots_at_step_two_as_in_jax():
    """bench_bert's FusedLAMB (lr 1e-3, weight decay 0.01, no warmup) from
    a random init raises the loss at step 2 and lowers it at step 3, in
    JAX as in the port: a reference behaviour, not a port fault (at
    BERT-large's full size the card shows a larger rise). A BERT with the
    real vocabulary (30528) at hidden 256, fp32, 8 x 128 tokens: the
    port's three losses within 1e-5 relative of JAX's (measured 2.3e-6:
    the fp32 trajectories part by a few ulps a step), the rise (1.7e-3
    relative) far outside that."""
    kw = dict(KW, hidden_size=256, vocab_size=30528,
              max_position_embeddings=512)
    b, s = 8, 128
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 30528, (b, s))
    padding = np.ones((b, s), np.int32)
    tokentype = np.zeros((b, s), np.int32)
    labels = rng.randint(0, 30528, (b, s))
    loss_mask = (rng.rand(b, s) < 0.15).astype(np.float32)
    nsp = rng.randint(0, 2, (b,))
    arrays = (tokens, padding, tokentype, labels, loss_mask, nsp)
    model_j = JaxBertModel(JaxConfig(**kw, compute_dtype=jnp.float32,
                                     attn_mask_type=JaxMaskType.padding))
    j = [jnp.asarray(a) for a in arrays]
    params = model_j.init(jax.random.PRNGKey(0), *j[:3])["params"]
    opt_j = JaxFusedLAMB(**LAMB)

    @jax.jit
    def step(p, state):
        def loss_fn(q):
            mlm, nsp_logits = model_j.apply({"params": q}, *j[:3])
            return jax_bert_loss_fn(mlm, nsp_logits, *j[3:])
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return (loss,) + opt_j.step(grads, state, p)

    want, p, state = [], params, opt_j.init(params)
    for _ in range(3):
        loss, p, state = step(p, state)
        want.append(float(loss))
    cfg = TransformerConfig(**kw, compute_dtype=torch.float32,
                            attn_mask_type=AttnMaskType.padding)
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(from_jax_params(_np_tree(params), cfg))
    opt = FusedLAMB(model.parameters(), **LAMB)
    got = []
    for _ in range(3):
        loss = _port_loss(model, arrays)
        loss.backward()
        opt.step()
        opt.zero_grad()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for losses in (want, got):
        assert losses[1] > losses[0] > losses[2], losses


def test_bert_parameters_keep_the_jax_names_and_shapes():
    tokens, padding, tokentype = (jnp.asarray(a) for a in _inputs()[:3])
    tree = _jax_model("float32").init(jax.random.PRNGKey(0), tokens, padding,
                                      tokentype)["params"]
    want = {k: tuple(v.shape) for k, v in from_jax_params(
        jax.tree.map(np.asarray, tree)).items()}
    cfg = TransformerConfig(**KW, attn_mask_type=AttnMaskType.padding)
    got = {k: tuple(v.shape)
           for k, v in BertModel(cfg, device="cpu").named_parameters()}
    assert got == want
    assert "lm_dense.kernel" in got and "binary_head.bias" in got


def test_init_weights_draws_embeddings_and_head_like_jax():
    """position, token-type and word embeddings and the untied lm_head ~
    N(0, 0.02), as JAX's normal(0.02); flax Dense kernels at the fan-in
    scale; LayerNorm weights 1, biases 0."""
    cfg = TransformerConfig(**dict(KW, hidden_size=256, vocab_size=1024),
                            attn_mask_type=AttnMaskType.padding)
    model = BertModel(cfg, num_tokentypes=64, device="cpu")
    init_weights(model, 0)
    named = dict(model.named_parameters())
    # >= 16,384 draws each: the sample std within 5 % of 0.02 (~6
    # standard errors)
    for name in ("position_embeddings", "tokentype_embeddings",
                 "word_embeddings.weight", "lm_head"):
        assert abs(named[name].std().item() - 0.02) < 1e-3, name
    assert abs(named["lm_dense.kernel"].std().item() - 256 ** -0.5) < 3e-3
    assert torch.equal(named["lm_layernorm.weight"], torch.ones(256))
    assert torch.equal(named["final_layernorm.bias"], torch.zeros(256))


def test_bert_refuses_the_causal_mask_type():
    with pytest.raises(ValueError, match="padding"):
        BertModel(TransformerConfig(**KW), device="cpu")


def test_bert_step_on_plain_versions_counts_no_launch():
    params, _ = _reference("float32")
    model = _port_model("float32", params)
    registry.reset()
    _port_loss(model, _inputs()).backward()
    FusedLAMB(model.parameters()).step()
    assert not any(registry.launches().values()), registry.launches()
