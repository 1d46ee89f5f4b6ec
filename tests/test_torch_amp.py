"""apex_tpu_torch.amp against apex_tpu.amp on the CPU: ``initialize`` at
O0-O3 (which parameters become bf16), three ``AmpOptimizer`` steps of a
small GPT (O2 + FusedAdam with amp's masters, O1 + FusedSGD) and a small
BERT (O2 + FusedMixedPrecisionLamb) with an overflow planted at step 2,
the O1 shim namespace against ``apex_tpu.amp.jnp`` / ``nn`` / ``lax``
op by op, the cast-list audit, ``scale_loss``, ``disable_casts``, the
decorators and the ``state_dict`` round trips.

Models: GPT-2-shaped (hidden 64, 2 layers, 4 heads, vocab 256, flash
off) on 2 x 32 tokens and BERT-shaped (the same widths, 64 positions,
padding mask type) on 2 x 32, bf16 compute, with weights drawn from a
numpy seed in the tree JAX's ``init`` makes, and carried into the port
with ``from_jax_params``; inputs from numpy seeds. JAX's models run op by op (no ``jax.jit``: under jit XLA
keeps excess precision across bf16 round trips), their LayerNorm and
softmax through the kernels' plain jnp references (the Pallas gates are
off on the CPU), and only forward: each step's gradients are the port's
(of its scaled loss), given to both optimizers, so the two sides step
from the same gradients. The JAX ``AmpOptimizer.step`` runs op by op;
with step 2 skipped its step counts are 1, 1, 2, where JAX's eager
integer power equals the traced one (``beta ** 2`` is one rounded
product), whose values the port's device bias corrections give.

Tolerances: the loss of each step within 2e-4 relative
(``tests/test_torch_gpt2.py``'s bf16 tolerance: the two forwards differ
in bf16 roundings only). Adam's and SGD's updates, the unscale and the
scaler are the same fp32 operations in the same order, so parameters,
masters, moments, step counts and scale are compared bit for bit. LAMB's
trust ratio and global norm are sums in another order: masters and
moments within 1e-6 relative plus 1e-7 absolute, bf16 parameters within
one bf16 ulp (2**-7 relative), as ``tests/test_torch_amp_optim.py``. The
shim's outputs: fp32 results within 1e-5 relative (torch's and XLA's
CPU transcendentals differ in the last places), bf16 results within one
bf16 ulp of the largest value, dtypes equal.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jax_amp
from apex_tpu.amp import jnp as jax_shim_jnp
from apex_tpu.amp import lax as jax_shim_lax
from apex_tpu.amp import lists as jax_lists
from apex_tpu.amp import nn as jax_shim_nn
from apex_tpu.models import BertModel as JaxBertModel
from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import bert_loss_fn as jax_bert_loss_fn
from apex_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedMixedPrecisionLamb as JaxFMPLamb
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.transformer import parallel_state
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu_torch import _autocast_utils, amp
from apex_tpu_torch.amp import functional as AF
from apex_tpu_torch.amp import lists
from apex_tpu_torch.models import (
    BertModel,
    GPTModel,
    TransformerConfig,
    bert_loss_fn,
    from_jax_params,
    gpt_loss_fn,
)
from apex_tpu_torch.optimizers import (
    FusedAdam,
    FusedMixedPrecisionLamb,
    FusedSGD,
)
from apex_tpu_torch.transformer.enums import AttnMaskType
from torch_threads import one_torch_thread  # noqa: F401

GPT_KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
              vocab_size=256, max_position_embeddings=128,
              use_flash_attention=False)
BERT_KW = dict(GPT_KW, max_position_embeddings=64)
BATCH, SEQ = 2, 32
LOSS_RTOL = 2e-4
LAMB_RTOL, LAMB_ATOL, BF16_RTOL = 1e-6, 1e-7, 2.0 ** -7
_LAYER = re.compile(r"^(transformer\.)?layer_(\d+)\.")
TDT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.bool_): torch.bool, jnp.dtype(jnp.int32): torch.int32}


@pytest.fixture(autouse=True)
def _fresh():
    parallel_state.destroy_model_parallel()
    yield
    for pkg in (amp, jax_amp):  # no O1 policy left behind
        pkg.initialize(None, enabled=False, verbosity=0)
        pkg._amp_state.reset()


def _port_name(path):
    return _LAYER.sub(r"\1layers.\2.", ".".join(
        str(getattr(k, "key", k)) for k in path))


def _named(tree):
    """{port name: leaf} of a JAX tree."""
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.__setitem__(_port_name(path), leaf), tree)
    return out


def _gpt_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, size=(BATCH, SEQ)),
            rng.randint(0, 256, size=(BATCH, SEQ)))


def _bert_batch():
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 256, size=(BATCH, SEQ))
    padding = np.ones((BATCH, SEQ), np.int32)
    tokentype = (rng.rand(BATCH, SEQ) < 0.5).astype(np.int32)
    labels = rng.randint(0, 256, size=(BATCH, SEQ))
    loss_mask = (rng.rand(BATCH, SEQ) < 0.15).astype(np.float32)
    nsp = rng.randint(0, 2, size=(BATCH,))
    return tokens, padding, tokentype, labels, loss_mask, nsp


@functools.lru_cache(maxsize=None)
def _jax_params(kind):
    """The JAX model's fp32 params (a tree of numpy arrays): the tree its
    ``init`` makes (traced abstractly, nothing compiled), drawn from a
    numpy seed: ~N(0, 0.02), norm weights 1 and biases 0."""
    if kind == "gpt":
        jm = JaxGPTModel(JaxConfig(**GPT_KW, compute_dtype=jnp.bfloat16))
        args = (jnp.asarray(_gpt_batch()[0]),)
    else:
        jm = JaxBertModel(JaxConfig(**BERT_KW, compute_dtype=jnp.bfloat16,
                                    attn_mask_type=JaxMaskType.padding))
        args = tuple(jnp.asarray(a) for a in _bert_batch()[:3])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(1), *args))
    rng = np.random.RandomState(7)

    def draw(path, leaf):
        name = _port_name(path)
        if "norm" in name:
            fill = np.zeros if name.endswith("bias") else np.ones
            return fill(leaf.shape, np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _models(kind):
    """(the JAX model's fp32 params, the port model carrying them, JAX's
    loss of params, the port's loss of the model)."""
    params = jax.tree.map(jnp.asarray, _jax_params(kind))
    if kind == "gpt":
        jm = JaxGPTModel(JaxConfig(**GPT_KW, compute_dtype=jnp.bfloat16))
        tokens, labels = _gpt_batch()
        cfg = TransformerConfig(**GPT_KW, compute_dtype=torch.bfloat16)
        model = GPTModel(cfg, device="cpu")

        def jloss(p):
            return jax_gpt_loss_fn(jm.apply({"params": p}, jnp.asarray(tokens)),
                                   jnp.asarray(labels))

        def tloss():
            return gpt_loss_fn(model(torch.from_numpy(tokens)),
                               torch.from_numpy(labels))
    else:
        jm = JaxBertModel(JaxConfig(**BERT_KW, compute_dtype=jnp.bfloat16,
                                    attn_mask_type=JaxMaskType.padding))
        batch = _bert_batch()
        tokens, padding, tokentype, labels, loss_mask, nsp = batch
        jb = [jnp.asarray(a) for a in batch]
        cfg = TransformerConfig(**BERT_KW, compute_dtype=torch.bfloat16,
                                attn_mask_type=AttnMaskType.padding)
        model = BertModel(cfg, device="cpu")
        tb = [torch.from_numpy(a) for a in batch]

        def jloss(p):
            mlm, nsp_logits = jm.apply({"params": p}, *jb[:3])
            return jax_bert_loss_fn(mlm, nsp_logits, *jb[3:])

        def tloss():
            mlm, nsp_logits = model(*tb[:3])
            return bert_loss_fn(mlm, nsp_logits, *tb[3:])
    model.load_state_dict(from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), cfg))
    return params, model, jloss, tloss


def _dtypes_of(tree):
    return {n: TDT[jnp.dtype(v.dtype)] for n, v in _named(tree).items()}


@pytest.mark.parametrize("kind", ["gpt", "bert"])
@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_initialize_casts_the_parameters_jax_casts(level, kind):
    """The bf16 and fp32 parameter sets after ``initialize`` are JAX's
    (O2 keeps exactly the norm layers' fp32: JAX's ``_is_norm_path`` on
    the flax paths, the port's ``is_norm_name`` on the same names); the
    optimizer built before it keeps stepping the same Parameter
    objects. Where the level computes in bf16 (O1 to O3), ``initialize``
    turns off cuBLAS's bf16 reduced-precision reduction, so each bf16
    GEMM rounds once from its fp32 sum, as JAX's does."""
    params, model, _, _ = _models(kind)
    cast, _ = jax_amp.initialize(params, None, opt_level=level, verbosity=0)
    before = list(model.parameters())
    opt = FusedAdam(model.parameters())
    cuda_matmul = torch.backends.cuda.matmul
    saved = cuda_matmul.allow_bf16_reduced_precision_reduction
    cuda_matmul.allow_bf16_reduced_precision_reduction = True
    try:
        out, opt = amp.initialize(model, opt, opt_level=level, verbosity=0)
        assert cuda_matmul.allow_bf16_reduced_precision_reduction == (
            level == "O0")
    finally:
        cuda_matmul.allow_bf16_reduced_precision_reduction = saved
    assert out is model and isinstance(opt, amp.AmpOptimizer)
    got = {n: p.dtype for n, p in model.named_parameters()}
    assert got == _dtypes_of(cast)
    assert all(a is b for a, b in zip(opt.param_groups[0]["params"],
                                      model.parameters()))
    assert all(a is b for a, b in zip(before, model.parameters()))
    n32 = sum(d == torch.float32 for d in got.values())
    if level == "O2":
        assert 0 < n32 < len(got)
        assert all(amp.frontend.is_norm_name(n) == (d == torch.float32)
                   for n, d in got.items())
    assert amp.current_policy().enabled == (level == "O1")


def _port_grads_to_jax(model, like):
    grads = {n: p.grad for n, p in model.named_parameters()}
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(
            grads[_port_name(path)].float().numpy()).astype(leaf.dtype),
        like)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


AMP_CASES = {
    "gpt_o2_adam": ("gpt", "O2", lambda ps: FusedAdam(ps, lr=1e-3),
                    JaxFusedAdam(lr=1e-3), "amp_master", True),
    "gpt_o1_sgd": ("gpt", "O1",
                   lambda ps: FusedSGD(ps, lr=0.05, momentum=0.9),
                   JaxFusedSGD(lr=0.05, momentum=0.9), None, True),
    "bert_o2_mp_lamb": ("bert", "O2",
                        lambda ps: FusedMixedPrecisionLamb(ps, lr=1e-3),
                        JaxFMPLamb(lr=1e-3), "master", False),
}


@pytest.mark.parametrize("case", list(AMP_CASES))
def test_amp_steps_match_jax_amp_optimizer(case):
    """Three steps from the same gradients (the port's, of its scaled
    loss), an inf planted into one at step 2: each step's loss as JAX's,
    and after each step the parameters, fp32 masters, moments, step
    counts and loss scale as JAX's; step 2 is skipped on both sides and
    halves the scale."""
    kind, level, make, jinner, master_key, exact = AMP_CASES[case]
    params, model, jloss, tloss = _models(kind)
    jparams, jopt = jax_amp.initialize(params, jinner, opt_level=level,
                                       verbosity=0)
    jstate = jopt.init(jparams)
    _, opt = amp.initialize(model, make(model.parameters()),
                            opt_level=level, verbosity=0)
    named = dict(model.named_parameters())
    victim = "transformer.layers.1.mlp.dense_h_to_4h.weight"

    def check(got, want, what):
        got, want = _host(got), _host(want)
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=what)
        elif want.dtype == np.float32 and what.startswith("param") and (
                named[what.split()[1]].dtype == torch.bfloat16):
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0,
                                       err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=LAMB_RTOL,
                                       atol=LAMB_ATOL, err_msg=what)

    for k in range(3):
        loss = tloss()
        want = float(jloss(jparams))
        assert abs(loss.item() - want) <= LOSS_RTOL * abs(want), (k, loss,
                                                                 want)
        with amp.scale_loss(loss, opt) as scaled:
            scaled.backward()
        if k == 1:
            named[victim].grad.view(-1)[7] = float("inf")
        jparams, jstate = jopt.step(_port_grads_to_jax(model, jparams),
                                    jstate, jparams)
        before = {n: p.detach().clone() for n, p in named.items()}
        opt.step()
        opt.zero_grad()
        assert opt.last_found_inf.item() == (1.0 if k == 1 else 0.0)
        if k == 1:
            assert all(torch.equal(p.detach(), before[n])
                       for n, p in named.items())
        inner = jstate["inner"]
        assert int(opt.param_groups[0]["step"]) == int(inner["step"]) == (
            1 if k < 2 else 2)
        assert (float(opt.scaler._state.loss_scale),
                int(opt.scaler._state.unskipped)) == (
            float(jstate["scaler"].loss_scale),
            int(jstate["scaler"].unskipped))
        jp = _named(jparams)
        for n, p in named.items():
            assert p.dtype == TDT[jnp.dtype(jp[n].dtype)], n
            check(p, jp[n], f"param {n} step {k}")
        keys = {"amp_master": "amp_master", "master": "master"}
        names = [key for key in ("exp_avg", "exp_avg_sq", "momentum_buffer",
                                 keys.get(master_key)) if key in inner]
        assert names, sorted(inner)
        for key in names:
            jt = _named(inner[key])
            for n, p in named.items():
                check(opt.state[p][key], jt[n], f"{key} {n} step {k}")
    assert float(opt.scaler._state.loss_scale) == (
        2.0 ** 15 if level != "O0" else 1.0)


# ------------------------------------------------------- the O1 shim

def _inputs():
    rng = np.random.RandomState(5)
    u = lambda *s: rng.uniform(0.1, 0.9, s).astype(np.float32)  # noqa: E731
    n = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    spd = n(4, 4)
    return dict(a=u(4, 5), b=u(4, 5), c=n(4, 6), x=n(4, 5), w=n(5, 3),
                v=n(5), v2=n(5), odd=u(5), m=n(4, 4), sym=spd + spd.T,
                spd=spd @ spd.T + 4 * np.eye(4, dtype=np.float32),
                r=n(4, 4), c3=n(4, 3), d3=n(4, 3), bx=n(2, 3, 4),
                bw=n(2, 4, 5), img=n(1, 2, 6, 6), ker=n(3, 2, 3, 3),
                sig=rng.uniform(-0.9, 0.9, (4, 5)).astype(np.float32),
                idx=np.array([0, 2, 1], np.int32),
                cond=rng.rand(4, 5) < 0.5)


# JAX list name -> (JAX call on the shim, torch call on the shim); one
# argument each as a name of _inputs(); the ``b`` arguments are bf16 on
# both sides, so PROMOTE ops see mixed dtypes
SHIM_CALLS = {
    # jnp HALF
    "matmul": (lambda m, i: m.matmul(i["x"], i["w"]),) * 2,
    "dot": (lambda m, i: m.dot(i["v"], i["v2"]),) * 2,
    "vdot": (lambda m, i: m.vdot(i["v"], i["v2"]),) * 2,
    "inner": (lambda m, i: m.inner(i["v"], i["v2"]),) * 2,
    "outer": (lambda m, i: m.outer(i["v"], i["v2"]),) * 2,
    "tensordot": (lambda m, i: m.tensordot(i["x"], i["w"], axes=1),
                  lambda m, i: m.tensordot(i["x"], i["w"], dims=1)),
    "einsum": (lambda m, i: m.einsum("ij,jk->ik", i["x"], i["w"]),) * 2,
    "kron": (lambda m, i: m.kron(i["v"], i["v2"]),) * 2,
    # jnp FLOAT (inputs bf16: the results fp32)
    **{k: (lambda m, i, k=k: getattr(m, k)(i["b"]),) * 2 for k in (
        "exp", "expm1", "log", "log1p", "log2", "log10", "reciprocal",
        "sinh", "cosh", "tan", "arcsin", "arccos", "arctan", "arcsinh",
        "arctanh", "nansum", "nanmean", "sum", "prod", "mean")},
    "arccosh": (lambda m, i: m.arccosh(1 + i["b"]),) * 2,
    "power": (lambda m, i: m.power(i["b"], i["a"]),
              lambda m, i: m.pow(i["b"], i["a"])),
    "float_power": (lambda m, i: m.float_power(i["b"], i["a"]),) * 2,
    "cumprod": (lambda m, i: m.cumprod(i["b"], axis=1),
                lambda m, i: m.cumprod(i["b"], dim=1)),
    "cumsum": (lambda m, i: m.cumsum(i["b"], axis=1),
               lambda m, i: m.cumsum(i["b"], dim=1)),
    "var": (lambda m, i: m.var(i["b"]),
            lambda m, i: m.var(i["b"], correction=0)),
    "std": (lambda m, i: m.std(i["b"]),
            lambda m, i: m.std(i["b"], correction=0)),
    "median": (lambda m, i: m.median(i["odd"]),) * 2,
    "trace": (lambda m, i: m.trace(i["m"]),) * 2,
    # jnp PROMOTE (a fp32 with b bf16: fp32)
    **{k: (lambda m, i, k=k: getattr(m, k)(i["a"], i["b"]),
           lambda m, i, k=k: getattr(m, lists.JNP_PROMOTE[k].split(":")[1])(
               i["a"], i["b"])) for k in (
        "add", "subtract", "multiply", "divide", "true_divide",
        "floor_divide", "remainder", "mod", "minimum", "maximum", "fmin",
        "fmax", "hypot", "heaviside", "logaddexp", "logaddexp2", "equal",
        "not_equal", "less", "less_equal", "greater", "greater_equal",
        "isclose", "arctan2")},
    **{k: (lambda m, i, k=k: getattr(m, k)([i["a"], i["b"]]),) * 2
       for k in ("concatenate", "stack", "hstack", "vstack", "dstack",
                 "column_stack")},
    "where": (lambda m, i: m.where(i["cond"], i["a"], i["b"]),) * 2,
    "allclose": (lambda m, i: m.allclose(i["a"], i["b"]),) * 2,
    "array_equal": (lambda m, i: m.array_equal(i["a"], i["b"]),
                    lambda m, i: m.equal(i["a"], i["b"])),
    "cross": (lambda m, i: m.cross(i["c3"], i["d3"]),
              lambda m, i: m.linalg.cross(i["c3"], i["d3"])),
    # nn HALF (fp32 in: bf16 out)
    **{k: (lambda m, i, k=k: getattr(m, k)(i["c"]),
           lambda m, i, k=k: getattr(m, lists.NN_HALF[k].split(":")[1])(
               i["c"])) for k in (
        "relu", "silu", "swish", "glu", "leaky_relu", "elu", "celu", "selu",
        "hard_tanh", "relu6")},
    "gelu": (lambda m, i: m.gelu(i["c"]),  # JAX's default: tanh
             lambda m, i: m.gelu(i["c"], approximate="tanh")),
    # nn FLOAT (bf16 in: fp32 out)
    **{k: (lambda m, i, k=k: getattr(m, k)(i["sb"]),
           lambda m, i, k=k: getattr(m, lists.NN_FLOAT[k].split(":")[1])(
               i["sb"])) for k in ("softplus", "sigmoid", "log_sigmoid")},
    "softmax": (lambda m, i: m.softmax(i["b"]),
                lambda m, i: m.softmax(i["b"], dim=-1)),
    "log_softmax": (lambda m, i: m.log_softmax(i["b"]),
                    lambda m, i: m.log_softmax(i["b"], dim=-1)),
    "logsumexp": (lambda m, i: m.logsumexp(i["b"]),
                  lambda m, i: m.logsumexp(i["b"], dim=(0, 1))),
    "one_hot": (lambda m, i: m.one_hot(i["idx"], 4),
                lambda m, i: m.one_hot(i["idx"].long(), 4)),
    # lax HALF (keys "lax.<name>": jnp and lax both have "dot")
    "lax.conv": (lambda m, i: m.conv(i["img"], i["ker"], (1, 1), "VALID"),
                 lambda m, i: m.conv2d(i["img"], i["ker"])),
    "lax.conv_with_general_padding": (
        lambda m, i: m.conv_with_general_padding(
            i["img"], i["ker"], (1, 1), [(0, 0), (0, 0)], (1, 1), (1, 1)),
        lambda m, i: m.conv2d(i["img"], i["ker"])),
    "lax.conv_general_dilated": (
        lambda m, i: m.conv_general_dilated(i["img"], i["ker"], (1, 1),
                                            "VALID"),
        lambda m, i: m.conv2d(i["img"], i["ker"])),
    "lax.conv_transpose": (
        lambda m, i: m.conv_transpose(i["img"], i["ker"], (1, 1), "VALID",
                                      dimension_numbers=("NCHW", "OIHW",
                                                         "NCHW")),
        None),  # other padding rules: the dtype is held, not the values
    "lax.dot": (lambda m, i: m.dot(i["x"], i["w"]),
                lambda m, i: m.matmul(i["x"], i["w"])),
    "lax.dot_general": (lambda m, i: m.dot_general(i["x"], i["w"],
                                               (((1,), (0,)), ((), ()))),
                    lambda m, i: m.tensordot(i["x"], i["w"], dims=1)),
    "lax.batch_matmul": (lambda m, i: m.batch_matmul(i["bx"], i["bw"]),
                     lambda m, i: m.bmm(i["bx"], i["bw"])),
    # lax FLOAT
    "lax.rsqrt": (lambda m, i: m.rsqrt(i["b"]),) * 2,
    "lax.erf_inv": (lambda m, i: m.erf_inv(i["sb"]),
                    lambda m, i: m.erfinv(i["sb"])),
}
LINALG_CALLS = {
    "norm": ("m", None), "cond": ("spd", None), "det": ("spd", None),
    "slogdet": ("spd", 1), "eigvals": ("m", "dtype"),
    "eigvalsh": ("sym", None), "svd": ("r", "dtype"), "qr": ("r", "dtype"),
    "cholesky": ("spd", None), "inv": ("spd", None), "pinv": ("spd", None),
    "solve": ("spd", None), "lstsq": ("spd", "dtype"),
    "matrix_power": ("spd", None), "matrix_rank": ("spd", "int"),
}
VALUES_DIFFER = {"float_power", "one_hot"}  # torch gives float64 / int64


def _shim_args(side):
    out = {}
    for k, v in _inputs().items():
        if side == "jax":
            out[k] = jnp.asarray(v)
        else:
            out[k] = torch.from_numpy(np.array(v))
    for k, src in (("b", "b"), ("sb", "sig")):  # bf16 on both sides
        out[k] = (out[src].astype(jnp.bfloat16) if side == "jax"
                  else out[src].bfloat16())
    return out


def _compare(got, want, what):
    if isinstance(want, (tuple, list)):
        got, want = got[0], want[0]
    if not isinstance(got, torch.Tensor):  # allclose, equal: a bool
        assert bool(got) == bool(want), what
        return
    wdt = jnp.dtype(want.dtype)
    if wdt in TDT:
        assert got.dtype == TDT[wdt], (what, got.dtype, wdt)
    g = got.detach().float().numpy() if got.dtype != torch.bool else (
        got.numpy())
    w = np.asarray(want.astype(jnp.float32) if want.dtype != jnp.bool_
                   else want)
    if got.dtype == torch.bool:
        np.testing.assert_array_equal(g, w, err_msg=what)
    elif got.dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(w).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)


def test_every_jax_list_name_is_mapped_to_torch_or_none():
    """The audit: each of JAX's JNP_*, NN_*, LAX_* and LINALG_FLOAT names
    maps to a torch function that exists, or to a stated "none"; the
    classes share no torch function; every mapped function is wrapped by
    the shim."""
    tables = {"JNP_HALF": lists.JNP_HALF, "JNP_FLOAT": lists.JNP_FLOAT,
              "JNP_PROMOTE": lists.JNP_PROMOTE, "NN_HALF": lists.NN_HALF,
              "NN_FLOAT": lists.NN_FLOAT, "LAX_HALF": lists.LAX_HALF,
              "LAX_FLOAT": lists.LAX_FLOAT,
              "LINALG_FLOAT": lists.LINALG_FLOAT}
    spaces = {"torch": torch, "F": F, "linalg": torch.linalg}
    for name, table in tables.items():
        assert set(table) == set(getattr(jax_lists, name)), name
        for key, target in table.items():
            for t in (target,) if isinstance(target, str) else target:
                space, fn = t.split(":", 1)
                if space == "none":
                    assert len(fn) > 20, (name, key)  # a stated reason
                else:
                    assert hasattr(spaces[space], fn), (name, key, t)
    half, flt, prom = set(lists.HALF), set(lists.FLOAT), set(lists.PROMOTE)
    assert not (half & flt or half & prom or flt & prom)
    for space, fn in half | flt | prom:
        shim = AF.linalg if space == "linalg" else AF
        assert getattr(shim, fn).__wrapped__ is getattr(spaces[space], fn)
    covered = set(SHIM_CALLS) | {f"linalg.{n}" for n in LINALG_CALLS}
    prefix = {"LAX_HALF": "lax.", "LAX_FLOAT": "lax.",
              "LINALG_FLOAT": "linalg."}
    mapped = {prefix.get(name, "") + k for name, t in tables.items()
              for k, v in t.items() if not str(v).startswith("none:")}
    assert mapped <= covered, sorted(mapped - covered)


@pytest.mark.parametrize("name", sorted(SHIM_CALLS))
def test_shim_op_matches_jax_shim(name):
    """Each listed op under the enabled policy: the port's shim gives
    JAX's result dtype (HALF bf16, FLOAT fp32, PROMOTE the widest) and
    its values; with the policy off both pass straight through."""
    jcall, tcall = SHIM_CALLS[name]
    jmod = (jax_shim_lax if name.startswith("lax.") else jax_shim_nn
            if name in jax_lists.NN_HALF + jax_lists.NN_FLOAT
            else jax_shim_jnp)
    with jax_amp.autocast():
        want = jcall(jmod, _shim_args("jax"))
    if tcall is None:  # JAX's padding rule has no torch twin: dtype only
        out = AF.conv_transpose2d
        with amp.autocast():
            got = out(torch.from_numpy(_inputs()["img"]),
                      torch.from_numpy(_inputs()["ker"]).transpose(0, 1))
        assert got.dtype == TDT[jnp.dtype(want.dtype)]
        return
    with amp.autocast():
        got = tcall(AF, _shim_args("torch"))
    if name in VALUES_DIFFER:  # torch's dtype is its own: values only
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-5)
    else:
        _compare(got, want, name)
    def outcome():  # torch's own result dtype, or its refusal
        try:
            return getattr(tcall(AF, _shim_args("torch")), "dtype", None)
        except RuntimeError as exc:  # mixed dtypes torch does not take
            return type(exc)

    plain = outcome()  # the policy off: as torch
    with amp.autocast(), amp.disable_casts():
        assert outcome() == plain


@pytest.mark.parametrize("name", sorted(LINALG_CALLS))
def test_shim_linalg_op_runs_in_fp32_as_jax(name):
    arg, kind = LINALG_CALLS[name]
    jargs, targs = _shim_args("jax"), _shim_args("torch")
    extra = {"solve": "spd", "lstsq": "spd"}.get(name)
    jin = [jargs[arg].astype(jnp.bfloat16)]
    tin = [targs[arg].bfloat16()]
    if extra:
        jin.append(jargs[extra][:, :1])
        tin.append(targs[extra][:, :1])
    if name == "matrix_power":
        jin.append(3)
        tin.append(3)
    with jax_amp.autocast():
        want = getattr(jax_shim_jnp.linalg, name)(*jin)
    with amp.autocast():
        got = getattr(AF.linalg, name)(*tin)
    if kind == "int":
        assert int(got) == int(want)
        return
    if kind == 1:  # slogdet: (sign, logabsdet)
        got, want = got[1], want[1]
    if kind == "dtype":
        g = got[0] if isinstance(got, tuple) else got
        w = want[0] if isinstance(want, tuple) else want
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, name
        return
    _compare(got, want, name)


def test_decorators_and_autocast_utils_follow_the_policy():
    @amp.half_function
    def h(x):
        return x

    @amp.float_function
    def f(x):
        return x

    @amp.promote_function
    def p(a, b):
        return a, b

    x = torch.ones(2)
    assert h(x).dtype == torch.float32  # the policy off: untouched
    with amp.autocast():
        assert h(x).dtype == torch.bfloat16
        assert f(x.bfloat16()).dtype == torch.float32
        a, b = p(x.bfloat16(), x)
        assert a.dtype == b.dtype == torch.float32
        with amp.disable_casts():
            assert h(x).dtype == torch.float32
    ns = type("NS", (), {"g": staticmethod(lambda t: t)})
    amp.register_half_function(ns, "g")
    with amp.autocast():
        assert ns.g(x).dtype == torch.bfloat16
    assert _autocast_utils._cast_if_autocast_enabled(x)[0].dtype == (
        torch.float32)
    model = torch.nn.Linear(2, 2)
    amp.initialize(model, None, opt_level="O1", verbosity=0)
    assert amp.current_policy().enabled
    cast = _autocast_utils._cast_if_autocast_enabled(x, 3)
    assert cast[0].dtype == torch.bfloat16 and cast[1] == 3
    assert _autocast_utils._get_current_dtype() == torch.bfloat16
    assert torch.bfloat16 in _autocast_utils._get_autocast_dtypes()


def test_scale_loss_state_dict_round_trip_and_master_params():
    """``scale_loss`` yields loss.float() times the live scale (the loss
    itself before amp is on); ``amp.state_dict`` / ``load_state_dict``
    restore every loss scaler; the AmpOptimizer's own state_dict keeps
    its fp32 masters and moments fp32 through the round trip."""
    loss = torch.tensor(1.5, dtype=torch.bfloat16)
    with amp.scale_loss(loss, None) as same:
        assert same is loss
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.LayerNorm(3))
    _, opt = amp.initialize(model, FusedAdam(model.parameters(), lr=0.1),
                            opt_level="O2", num_losses=2, verbosity=0)
    with amp.scale_loss(loss, opt, loss_id=1) as scaled:
        assert scaled.dtype == torch.float32 and scaled.item() == 1.5 * 2 ** 16
    jl = jnp.asarray(1.5, jnp.bfloat16)
    jax_amp.initialize({"w": jnp.ones(2)}, JaxFusedAdam(), opt_level="O2",
                       verbosity=0)
    with jax_amp.scale_loss(jl, None) as jscaled:
        assert float(jscaled) == scaled.item()
    with pytest.raises(RuntimeError, match="loss_id"):
        with amp.scale_loss(loss, opt, loss_id=2):
            pass
    model(torch.randn(2, 4).bfloat16()).float().sum().backward()
    next(model.parameters()).grad.view(-1)[0] = float("inf")
    opt.step()  # an overflow: the scale halves
    sd = amp.state_dict()
    assert sd["loss_scaler0"]["loss_scale"] == 2.0 ** 15
    assert sd["loss_scaler1"]["loss_scale"] == 2.0 ** 16
    osd = opt.state_dict()
    _, opt2 = amp.initialize(model, FusedAdam(model.parameters(), lr=0.1),
                             opt_level="O2", num_losses=2, verbosity=0)
    amp.load_state_dict(sd)
    assert amp.state_dict() == sd
    opt2.load_state_dict(osd)
    for p in model.parameters():
        for key in ("amp_master", "exp_avg", "exp_avg_sq"):
            assert opt2.state[p][key].dtype == torch.float32, key
            assert torch.equal(opt2.state[p][key], opt.state[p][key])
    masters = list(amp.master_params(opt))
    assert len(masters) == 4 and all(m.dtype == torch.float32
                                     for m in masters)
    assert all(m.data_ptr() != p.data_ptr()
               for m, p in zip(masters, model.parameters()))
