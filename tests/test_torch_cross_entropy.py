"""apex_tpu_torch's vocab-parallel cross entropy and embedding on labels
and tokens outside the vocabulary, against apex_tpu's on the CPU.

JAX masks a target outside ``[0, vocab)`` to index 0 with a predicted
logit of 0, and its gather wraps a negative index once and clamps the
rest; the port must do the same rather than raise (an ignore label of
-100 is the common case). Inputs come from numpy seeds. Tolerance: rtol
1e-6 on the loss and 1e-6 absolute on the gradients (the same fp32
operations; sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.transformer.tensor_parallel import (
    VocabParallelEmbedding as JaxEmbedding,
)
from apex_tpu.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_cross_entropy,
)
from apex_tpu_torch.models import gpt_loss_fn
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    vocab_parallel_cross_entropy,
)
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 16
LABELS = [
    [[1, 2, 3, -100], [4, 5, -100, -100]],        # ignore labels
    [[1, 2, 3, VOCAB], [4, VOCAB + 7, -1, 0]],    # = vocab, past it, -1
]


def _logits(seed=0):
    return np.random.RandomState(seed).randn(2, 4, VOCAB).astype(np.float32)


@pytest.mark.parametrize("labels", LABELS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_per_token_loss_and_gradient_match_jax(labels, smoothing):
    logits, labels = _logits(), np.asarray(labels)

    def jax_sum(x):
        return jnp.sum(jax_cross_entropy(x, jnp.asarray(labels), smoothing))

    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             smoothing)
    want_grad = jax.grad(jax_sum)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = vocab_parallel_cross_entropy(x, torch.from_numpy(labels),
                                       smoothing)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("labels", LABELS)
def test_gpt_loss_with_ignore_labels_matches_jax(labels):
    logits, labels = _logits(), np.asarray(labels)
    mask = (labels >= 0) & (labels < VOCAB)

    def jax_loss(x):
        return jax_gpt_loss_fn(x, jnp.asarray(labels),
                               jnp.asarray(mask, jnp.float32))

    want = jax_loss(jnp.asarray(logits))
    want_grad = jax.grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = gpt_loss_fn(x, torch.from_numpy(labels), torch.from_numpy(mask))
    got.backward()
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-6)


def test_gpt_loss_unmasked_counts_out_of_range_targets_as_logit_zero():
    """Without a loss mask, an out-of-range target's loss is
    log(sum(exp(shifted logits))): its predicted logit is 0, as in JAX."""
    logits, labels = _logits(1), np.asarray(LABELS[1])
    want = jax_gpt_loss_fn(jnp.asarray(logits), jnp.asarray(labels))
    got = gpt_loss_fn(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_embedding_clamps_out_of_range_tokens_as_jax():
    table = np.random.RandomState(2).randn(VOCAB, 8).astype(np.float32)
    tokens = np.asarray([[0, 3, VOCAB - 1, VOCAB], [VOCAB + 5, -1, -3,
                                                    -VOCAB - 9]])
    jax_emb = JaxEmbedding(num_embeddings=VOCAB, embedding_dim=8)
    want = jax_emb.apply({"params": {"weight": jnp.asarray(table)}},
                         jnp.asarray(tokens))
    emb = VocabParallelEmbedding(VOCAB, 8, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
    got = emb(torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
