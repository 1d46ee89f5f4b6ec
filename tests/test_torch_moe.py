"""apex_tpu_torch.transformer.moe (sorted routing, TopKRouter, ExpertMLP
and SwitchMLP with the ragged and scatter dispatches) against
apex_tpu's on the CPU.

Inputs come from numpy seeds; parameters are drawn by the JAX module
and carried across. Tolerances: routing indices, counts and slots
exact; gates, aux and z losses rtol 1e-6 (the same fp32 operations). The
layer's output in fp32 within 1e-5 (fp32 expert sums in another order);
in bf16 within 2**-7 relative plus 2**-8 of the largest |output| (one
bf16 ulp: the fp32 products and sums, rounded to bf16 between the two
expert products and at the end, may round the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.moe import SwitchMLP as JaxSwitchMLP
from apex_tpu.transformer.moe import TopKRouter as JaxTopKRouter
from apex_tpu.transformer.moe import compute_routing_sorted as jax_routing
from apex_tpu.transformer.moe.router import (
    expert_capacity as jax_expert_capacity,
)
from apex_tpu_torch.models import from_jax_params
from apex_tpu_torch.transformer.moe import (
    SwitchMLP,
    TopKRouter,
    compute_routing_sorted,
    expert_capacity,
)
from torch_threads import one_torch_thread  # noqa: F401

E, H, F = 8, 32, 48


def _logits(seed, T, ties=False):
    logits = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    if ties:  # equal probabilities: the lower expert index must win
        logits[:, 5] = logits[:, 2]
        logits[::3, 7] = logits[::3, 0]
    return logits


def _same_routing(got, want, capacity):
    for name in ("token_idx", "expert_idx", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    if capacity is None:
        assert got.slot is None
    else:
        np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    for name in ("gate", "aux_loss", "z_loss", "probs", "dropped_fraction"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("capacity", [None, 8])
@pytest.mark.parametrize("normalize", [False, True])
def test_sorted_routing_matches_jax(capacity, k, ties, normalize):
    logits = _logits(k, 40, ties)
    want = jax_routing(jnp.asarray(logits), k, capacity, normalize)
    got = compute_routing_sorted(torch.from_numpy(logits), k, capacity,
                                 normalize)
    _same_routing(got, want, capacity)


@pytest.mark.parametrize("T,k,cf", [(4096, 6, 64 / 6), (8, 6, 64 / 6),
                                    (1, 2, 1.25), (40, 2, 1.25),
                                    (100, 6, 1.0)])
def test_expert_capacity_matches_jax(T, k, cf):
    assert expert_capacity(T, 64, k, cf) == jax_expert_capacity(T, 64, k, cf)


@pytest.mark.parametrize("fmt", ["sorted", "sorted_dropless"])
def test_top_k_router_matches_jax(fmt):
    x = np.random.RandomState(3).randn(24, H).astype(np.float32)
    jr = JaxTopKRouter(num_experts=E, top_k=2, capacity_factor=1.0,
                       normalize_topk=False, routing_format=fmt)
    params = jr.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jr.apply(params, jnp.asarray(x))
    router = TopKRouter(H, E, top_k=2, capacity_factor=1.0,
                        normalize_topk=False, routing_format=fmt,
                        device="cpu")
    router.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params["params"])))
    got = router(torch.from_numpy(x))
    _same_routing(got, want, None if fmt == "sorted_dropless" else
                  expert_capacity(24, E, 2, 1.0))


@pytest.mark.parametrize("fmt,other", [("sorted", "sorted_dropless"),
                                       ("sorted_dropless", "sorted")])
def test_top_k_router_call_format_overrides_its_own(fmt, other):
    """A call's routing_format (SwitchMLP passes its dispatch's) routes as
    a JAX router built with that format."""
    x = np.random.RandomState(4).randn(24, H).astype(np.float32)
    jr = JaxTopKRouter(num_experts=E, top_k=2, capacity_factor=1.0,
                       normalize_topk=False, routing_format=other)
    params = jr.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jr.apply(params, jnp.asarray(x))
    router = TopKRouter(H, E, top_k=2, capacity_factor=1.0,
                        normalize_topk=False, routing_format=fmt,
                        device="cpu")
    router.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, params["params"])))
    got = router(torch.from_numpy(x), routing_format=other)
    _same_routing(got, want, None if other == "sorted_dropless" else
                  expert_capacity(24, E, 2, 1.0))


@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("mode,capf", [("ragged", None), ("scatter", 1.0),
                                       ("auto", None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_switch_mlp_matches_jax(mode, capf, act, k, dtype):
    capf = float(E) / k if capf is None else capf
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = np.random.RandomState(k).randn(6, 4, H).astype(np.float32)
    jm = JaxSwitchMLP(hidden_size=H, ffn_hidden_size=F, num_experts=E,
                      top_k=k, capacity_factor=capf, activation=act,
                      dispatch_mode=mode, normalize_topk=False,
                      compute_dtype=jd, warn_on_dropped_losses=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(k),
                                              jnp.asarray(x, jd)))
    experts = params["params"]["experts"]
    for name in ("b1", "b2"):  # nonzero gelu biases (zeros at init)
        if name in experts:
            experts[name] = np.random.RandomState(1).randn(
                *experts[name].shape).astype(np.float32) * 0.1
    want, var = jm.apply(params, jnp.asarray(x, jd), mutable=["moe_losses"])
    m = SwitchMLP(H, F, E, top_k=k, capacity_factor=capf, activation=act,
                  dispatch_mode=mode, normalize_topk=False, compute_dtype=td,
                  device="cpu")
    m.load_state_dict(from_jax_params(params["params"]))
    got = m(torch.from_numpy(x).to(td))
    assert got.dtype == td and got.shape == x.shape
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * np.abs(want).max())
    losses = var["moe_losses"]
    for name in ("aux_loss", "z_loss", "dropped_fraction"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(losses[name][0]), rtol=1e-6,
                                   atol=1e-7)


def test_switch_mlp_backward_runs_through_the_grouped_products():
    """The ragged dispatch is differentiable in the input and every
    parameter (the port's training forward takes it)."""
    m = SwitchMLP(H, F, E, top_k=2, capacity_factor=4.0,
                  activation="swiglu", compute_dtype=torch.float32,
                  device="cpu")
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.2, generator=torch.Generator()
                              .manual_seed(0))
    x = torch.randn(5, 2, H, requires_grad=True)
    (m(x).square().sum() + m.aux_loss).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is not None for p in m.parameters())


@pytest.mark.parametrize("kw", [dict(dispatch_mode="einsum"),
                                dict(sequence_parallel_enabled=True),
                                dict(router_type="expert_choice"),
                                dict(jitter_eps=0.01)])
def test_unported_options_raise_naming_the_roadmap_item(kw):
    with pytest.raises(NotImplementedError, match="item 6"):
        SwitchMLP(H, F, E, device="cpu", **kw)


def test_dense_routing_format_raises():
    with pytest.raises(NotImplementedError, match="item 6"):
        TopKRouter(H, E, routing_format="dense", device="cpu")
