"""apex_tpu_torch's Adagrad and NovoGrad (kernels/optim ``adagrad`` and
``novograd``, ops ``multi_tensor_adagrad`` / ``multi_tensor_novograd``,
optimizers ``FusedAdagrad`` / ``FusedNovoGrad``) against apex_tpu's on
the CPU, where the wrappers take their plain versions; the C interfaces
of csrc/adagrad.cu and csrc/novograd.cu; a model of the NovoGrad
kernel's fixed-order norm.

Inputs come from numpy seeds: four tensors of ragged sizes, fp32 or
bf16 gradients (on bf16 parameters with fp32 masters that amp keeps).
The JAX optimizers take four steps, one of them skipped on
``found_inf``; Adagrad's op by op.

Tolerances: Adagrad is the same fp32 operations in the same order,
elementwise (FusedAdagrad's division by the scale included), so
parameters, sums and step counts are compared bit for bit. NovoGrad's
L2 norms are sums in another order (torch's against XLA's reduce), so
its parameters, moments and second moments are held within 1e-6
relative plus 1e-7 absolute (what a few fp32 ulps of each norm move
them); with the max norm, an exact reduction, they are compared bit for
bit. JAX's bias correction ``1 - beta1**step`` is its traced fp32 power
only under jit, which the port's device value equals at every step
(held here to step 3000); so NovoGrad's steps are held to JAX's jitted
step. A skipped step leaves every tensor bit-identical on both sides.
"""

import copy
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import multi_tensor as jax_mt
from apex_tpu.optimizers import FusedAdagrad as JaxFusedAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JaxFusedNovoGrad
from apex_tpu_torch.kernels import _build, registry
from apex_tpu_torch.kernels import optim
from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [(7, 5), (1,), (300,), (4, 3, 2)]
RTOL, ATOL = 1e-6, 1e-7
# (gradient seed, gradient scale, found_inf) of each step: the optimizer
# is stepped with scale= the gradient scale; the second step is skipped
STEPS = [(11, 4.0, 0.0), (12, 4.0, 1.0), (13, 2.0, 0.0), (14, 1.0, 0.0)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(seed, scale=1.0, positive=False):
    rng = np.random.RandomState(seed)
    draw = rng.rand if positive else rng.randn
    return [(draw(*s) * scale).astype(np.float32) for s in SIZES]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_host(g), _host(w),
                                      err_msg=f"{what} {k}")


def _close(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_host(g), _host(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def _leaves(tree):
    return [tree[f"t{k}"] for k in range(len(SIZES))]


def _run_both(jopt, make, gdtype, jit=False):
    """Four steps (STEPS) of the JAX optimizer and the port's (``make``
    over the parameters) from the same parameters; yields (k, jax params,
    jax state, port optimizer, port targets) after each. With bf16
    gradients the port's parameters are bf16 and its targets fp32 masters
    that amp keeps (state "amp_master", the parameters written from them),
    the JAX parameters those masters' values."""
    tdt, jdt = DTYPES[gdtype]
    p0 = [torch.from_numpy(a).to(tdt).float() for a in _np(3)]
    params = [torch.nn.Parameter(p.to(tdt)) for p in p0]
    topt = make(params)
    key = None
    targets = params
    if tdt != torch.float32:
        key = "amp_master"
        targets = [p.clone() for p in p0]
        for p, m in zip(params, targets):
            topt.state[p][key] = m
    # JAX's own copies: jnp.asarray may alias a numpy buffer, which the
    # port's in-place steps would then move under JAX
    jp = {f"t{k}": jnp.array(p.numpy()) for k, p in enumerate(p0)}
    js = jopt.init(jp)
    step = jax.jit(jopt.step) if jit else jopt.step
    for k, (seed, gscale, found) in enumerate(STEPS):
        g = _np(seed, gscale)
        grads = {f"t{i}": jnp.asarray(a).astype(jdt) for i, a in enumerate(g)}
        before = [t.detach().clone() for t in targets + params]
        jp, js = step(grads, js, jp, found_inf=jnp.float32(found),
                      scale=gscale)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy()).to(tdt)
        with torch.no_grad():  # as step() and amp's step run it
            topt._update(torch.tensor([found]), gscale, key)
        topt.zero_grad()
        if found:
            _equal(targets + params, before, f"skipped step {k}")
        if key is not None:
            _equal(params, [m.to(tdt) for m in targets],
                   f"parameters written from the masters at step {k}")
        assert int(topt.param_groups[0]["step"]) == int(js["step"]), k
        yield k, jp, js, topt, targets


def _params():
    return [torch.nn.Parameter(torch.from_numpy(a)) for a in _np(3)]


# ------------------------------------------------------------- Adagrad

@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_mode", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adagrad_matches_jax_bit_for_bit(w_mode, wd, gdtype):
    """Four steps (scale 4, 4, 2, 1: the division; the second skipped on
    found_inf): parameters, sums and step counts as JAX's, bit for bit."""
    kw = dict(lr=0.05, eps=1e-10, weight_decay=wd, adagrad_w_mode=w_mode)
    for k, jp, js, topt, targets in _run_both(
            JaxFusedAdagrad(**kw), lambda ps: FusedAdagrad(ps, **kw), gdtype):
        _equal(targets, _leaves(jp), f"params after step {k}")
        _equal([topt.state[p]["sum"] for g in topt.param_groups
                for p in g["params"]], _leaves(js["sum"]),
               f"sums after step {k}")


@pytest.mark.parametrize("mode,wd", [(0, 0.0), (0, 0.01), (1, 0.01)])
@pytest.mark.parametrize("noop", [0.0, 1.0])
def test_multi_tensor_adagrad_matches_jax(mode, wd, noop):
    g, p, h = _np(21), _np(22), _np(23, positive=True)
    flag = jnp.float32(noop)
    want_p, want_h, _ = jax_mt.multi_tensor_adagrad(
        flag, [[jnp.asarray(a) for a in x] for x in (g, p, h)], 0.1, 1e-8,
        mode, wd)
    tp, th = ([torch.from_numpy(a.copy()) for a in x] for x in (p, h))
    mt.multi_tensor_adagrad(torch.tensor([noop]),
                            [[torch.from_numpy(a) for a in g], tp, th], 0.1,
                            1e-8, mode, wd)
    _equal(tp, want_p, "params")
    _equal(th, want_h, "sums")
    if noop:
        _equal(tp, p, "kept params")


def test_adagrad_plain_version_counts_no_launch_and_refuses_a_mode():
    before = registry.launches()
    params = _params()
    for p in params:
        p.grad = torch.ones_like(p)
    FusedAdagrad(params).step()
    assert registry.launches() == before
    with pytest.raises(ValueError, match="mode"):
        mt.multi_tensor_adagrad(torch.zeros(1), [[], [], []], 0.1, 1e-8, 2,
                                0.0)


# ------------------------------------------------------------ NovoGrad

NOVOGRAD_CASES = {
    "l2": dict(),
    "inf": dict(norm_type=float("inf")),
    "init_zero": dict(init_zero=True),
    "inside_moment": dict(reg_inside_moment=True, weight_decay=0.01),
    "decoupled": dict(weight_decay=0.01),
    "no_averaging": dict(grad_averaging=False, weight_decay=0.01),
    "no_bias_correction": dict(bias_correction=False),
    "inf_init_zero_inside": dict(norm_type=float("inf"), init_zero=True,
                                 reg_inside_moment=True, weight_decay=0.01),
}


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(NOVOGRAD_CASES))
def test_fused_novograd_matches_jax(case, gdtype):
    """Four steps, the second skipped: parameters, exp_avg, the stacked
    second moments and the step count as JAX's jitted step gives them
    (bit for bit with the max norm; L2 norms within RTOL/ATOL)."""
    kw = dict(lr=0.01, betas=(0.9, 0.98), eps=1e-8,
              **NOVOGRAD_CASES[case])
    exact = kw.get("norm_type") == float("inf")
    check = _equal if exact else _close
    for k, jp, js, topt, targets in _run_both(
            JaxFusedNovoGrad(**kw), lambda ps: FusedNovoGrad(ps, **kw),
            gdtype, jit=True):
        check(targets, _leaves(jp), f"params after step {k}")
        check([topt.state[p]["exp_avg"] for p in topt.param_groups[0][
            "params"]], _leaves(js["exp_avg"]), f"exp_avg after step {k}")
        check([topt.param_groups[0]["exp_avg_sq"]], [js["exp_avg_sq"]],
              f"exp_avg_sq after step {k}")


def test_novograd_first_clean_step_after_a_skipped_one_takes_first_v():
    """A first step skipped on found_inf leaves the count at 0 and v at 0;
    the next, clean step is step 1 and takes the first value (the norm,
    or (1 - beta2) * norm with init_zero), as JAX's."""
    for init_zero in (False, True):
        kw = dict(lr=0.01, betas=(0.9, 0.98), init_zero=init_zero)
        params = _params()
        topt = FusedNovoGrad(params, **kw)
        jopt = JaxFusedNovoGrad(**kw)
        jp = {f"t{k}": jnp.array(p.detach().numpy())  # a copy, as above
              for k, p in enumerate(params)}
        js = jopt.init(jp)
        step = jax.jit(jopt.step)
        for seed, found in ((31, 1.0), (32, 0.0)):
            g = _np(seed)
            jp, js = step({f"t{i}": jnp.asarray(a) for i, a in enumerate(g)},
                          js, jp, found_inf=jnp.float32(found))
            for p, a in zip(params, g):
                p.grad = torch.from_numpy(a.copy())
            topt.step(found_inf=torch.tensor([found]))
            if found:
                v = topt.param_groups[0]["exp_avg_sq"]
                assert int(topt.param_groups[0]["step"]) == 0
                assert torch.equal(v, torch.zeros_like(v))
        norms = torch.stack([torch.square(torch.from_numpy(a)).sum()
                             for a in _np(32)])
        want = (torch.tensor(1 - 0.98, dtype=torch.float32) * norms
                if init_zero else norms)
        assert int(topt.param_groups[0]["step"]) == 1
        _close([topt.param_groups[0]["exp_avg_sq"]], [want], "first v")
        _close([topt.param_groups[0]["exp_avg_sq"]], [js["exp_avg_sq"]],
               "first v against JAX")


@pytest.mark.parametrize("norm_type", [2, 0])
@pytest.mark.parametrize("moment_mode", [0, 1])
def test_multi_tensor_novograd_matches_jax(norm_type, moment_mode):
    """The op at a traced step 3 (JAX under jit), bf16 gradients, decay."""
    g, p, m = _np(41), _np(42), _np(43, 0.1)
    v0 = np.abs(np.random.RandomState(44).randn(len(SIZES))).astype(
        np.float32)
    args = (0.01, 0.9, 0.98, 1e-8)

    @jax.jit
    def run(step):
        return jax_mt.multi_tensor_novograd(
            jnp.float32(0.0), [[jnp.asarray(a).astype(jnp.bfloat16)
                                for a in g], [jnp.asarray(a) for a in p],
                               [jnp.asarray(a) for a in m], jnp.asarray(v0)],
            *args, step, True, 0.01, True, moment_mode, norm_type)

    want_p, want_m, want_v, _ = run(jnp.int32(3))
    tp, tm = ([torch.from_numpy(a.copy()) for a in x] for x in (p, m))
    tv = torch.from_numpy(v0.copy())
    mt.multi_tensor_novograd(
        torch.zeros(1), [[torch.from_numpy(a).bfloat16() for a in g], tp, tm,
                         tv], *args, torch.tensor([3], dtype=torch.int32),
        True, 0.01, True, moment_mode, norm_type)
    check = _equal if norm_type == 0 else _close
    check(tp, want_p, "params")
    check(tm, want_m, "exp_avg")
    check([tv], [want_v], "v")


def test_novograd_noop_leaves_everything_and_counts_no_launch():
    g, p, m = _np(51), _np(52), _np(53)
    tp, tm = ([torch.from_numpy(a.copy()) for a in x] for x in (p, m))
    tv = torch.ones(len(SIZES))
    before = registry.launches()
    mt.multi_tensor_novograd(torch.ones(1),
                             [[torch.from_numpy(a) for a in g], tp, tm, tv],
                             0.01, 0.9, 0.98, 1e-8, 1, True, 0.0, True, 1, 2)
    assert registry.launches() == before
    _equal(tp, p, "params")
    _equal(tm, m, "exp_avg")
    assert torch.equal(tv, torch.ones(len(SIZES)))


def test_novograd_bias_correction_equals_jax_traced_power():
    """bc1 as the kernel and the plain version take it from the device
    step (multi_tensor.cuh ``bias_correction``; ``device_bias_corrections``
    on the CPU) equals JAX's jitted ``1.0 - beta1 ** step`` (the traced
    int32 step of FusedNovoGrad) at every step to 3000, for two betas."""
    steps = jnp.arange(1, 3001, dtype=jnp.int32)
    for beta1 in (0.9, 0.95):
        want = np.asarray(jax.jit(jax.vmap(lambda s: 1.0 - beta1 ** s))(
            steps))
        got = np.array([optim.device_bias_corrections(
            beta1, 0.999, torch.tensor([k], dtype=torch.int32))[0].item()
            for k in range(1, 3001)], dtype=np.float32)
        np.testing.assert_array_equal(got, want)


def test_fused_novograd_refuses_what_it_does_not_have():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(_params(), amsgrad=True)
    with pytest.raises(RuntimeError, match="l2/inf"):
        FusedNovoGrad(_params(), norm_type=1)


def test_novograd_second_moments_go_through_the_state_dict():
    """exp_avg_sq (the group's vector) and the step count survive a
    state_dict round trip; the next step from the loaded optimizer equals
    the next step of the original."""
    kw = dict(lr=0.01, weight_decay=0.01)
    a, b = _params(), _params()
    opt_a = FusedNovoGrad(a, **kw)
    for seed in (61, 62):
        for p, g in zip(a, _np(seed)):
            p.grad = torch.from_numpy(g)
        opt_a.step()
    sd = copy.deepcopy(opt_a.state_dict())  # as saved: no shared tensor
    with torch.no_grad():
        for p, q in zip(b, a):
            p.copy_(q)
    opt_b = FusedNovoGrad(b, **kw)
    opt_b.load_state_dict(sd)
    assert torch.equal(opt_b.param_groups[0]["exp_avg_sq"],
                       opt_a.param_groups[0]["exp_avg_sq"])
    for p, q, g in zip(a, b, _np(63)):
        p.grad = torch.from_numpy(g)
        q.grad = torch.from_numpy(g.copy())
    opt_a.step()
    opt_b.step()
    _equal(b, a, "params after the loaded step")
    assert int(opt_b.param_groups[0]["step"]) == 3


def test_novograd_slots_skip_parameters_without_grad():
    """A parameter without a gradient keeps its v entry; the others take
    theirs at their own position in the group."""
    params = _params()
    opt = FusedNovoGrad(params, lr=0.01)
    for k, (p, g) in enumerate(zip(params, _np(71))):
        p.grad = None if k == 1 else torch.from_numpy(g)
    opt.step()
    v = opt.param_groups[0]["exp_avg_sq"]
    assert v[1].item() == 0.0
    for k in (0, 2, 3):
        want = torch.square(torch.from_numpy(_np(71)[k])).sum()
        np.testing.assert_allclose(v[k].item(), want.item(), rtol=RTOL)


# ------------------------------------------------ the fixed-order norm

THREADS, UNROLL, WARPS = 256, 4, 8


def _kernel_norm_model(g, head, l2=True):
    """novograd.cu's norm of one tensor (fp32 numpy ``g``, already
    divided), in the kernel's order: per chunk, each thread's vector
    elements (its kUnroll vectors in turn, x y z w) then its scalars; each
    warp's xor butterfly; the warps in order; then the tensor's partials,
    each thread's strided share in turn and the block as before."""
    f = np.float32

    def add(a, b):
        return f(a + b) if l2 else (a if (a != a or a > b) else b)

    def acc_of(x):
        return f(x * x) if l2 else f(abs(x))

    def block(vals):  # vals: THREADS per-thread values
        lanes = [list(vals[w * 32:(w + 1) * 32]) for w in range(WARPS)]
        for w in range(WARPS):
            x = lanes[w]
            o = 16
            while o:
                x = [add(x[i], x[i ^ o]) for i in range(32)]
                o //= 2
            lanes[w] = x
        r = lanes[0][0]
        for w in range(1, WARPS):
            r = add(r, lanes[w][0])
        return r

    size = g.size
    vecs = (size - head) // 4
    scalars = size - 4 * vecs
    vchunk = THREADS * UNROLL
    chunks = max(-(-vecs // vchunk), -(-scalars // (4 * vchunk)))
    partials = []
    body = g[head:]
    for c in range(chunks):
        accs = []
        for t in range(THREADS):
            acc = f(0.0)
            for u in range(UNROLL):
                i = c * vchunk + t + u * THREADS
                if i < vecs:
                    for e in body[4 * i:4 * i + 4]:
                        acc = add(acc, acc_of(e))
            q = c * 4 * vchunk + t
            while q < min((c + 1) * 4 * vchunk, scalars):
                e = q if q < head else q + 4 * vecs
                acc = add(acc, acc_of(g[e]))
                q += THREADS
            accs.append(acc)
        partials.append(block(accs))
    accs = []
    for t in range(THREADS):
        acc = f(0.0)
        for c in range(t, len(partials), THREADS):
            acc = add(acc, partials[c])
        accs.append(acc)
    total = block(accs)
    return total if l2 else f(total * total)


@pytest.mark.parametrize("size,head", [(1, 1), (7, 3), (4099, 0), (4099, 2),
                                       (9000, 9000), (20000, 1)])
@pytest.mark.parametrize("l2", [True, False])
def test_kernel_norm_model_agrees_with_the_plain_version(size, head, l2):
    """The model of the kernel's fixed-order norm within RTOL of the plain
    version's torch sum (bit for bit for the max), at sizes of one and of
    several chunks, aligned and with heads, all head."""
    g = np.random.RandomState(size + head).randn(size).astype(np.float32)
    got = _kernel_norm_model(g, head, l2)
    want = optim.novograd_norms_plain([torch.from_numpy(g)],
                                      norm_type=2 if l2 else 0)[0].item()
    if l2:
        np.testing.assert_allclose(got, want, rtol=RTOL)
        exact = np.sum(g.astype(np.float64) ** 2)
        np.testing.assert_allclose(got, exact, rtol=RTOL)
    else:
        assert got == np.float32(want)


def test_novograd_scratch_covers_every_chunk():
    """The wrapper's scratch holds a partial for every chunk the C
    function counts (csrc/multi_tensor.cuh ``stream_chunks`` at any head)
    plus the blocks' count."""
    vchunk = THREADS * UNROLL
    for size in (0, 1, 3, 4095, 4096, 4097, 70001, 1 << 20):
        for head in {0, 1, 2, 3, size}:
            if head > size:
                continue
            vecs = (size - head) // 4
            chunks = max(-(-vecs // vchunk),
                         -(-(size - 4 * vecs) // (4 * vchunk)))
            assert chunks <= optim.novograd_scratch([size]) - 1, (size, head)
    assert optim.STREAM_CHUNK == 4 * vchunk


# ---------------------------------------------------- the C interfaces

_CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"


def _c_argtypes(lib, symbol):
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)',
                       (_CSRC / f"{lib}.cu").read_text()).group(1)
    kinds = []
    for param in params.split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        else:
            kinds.append({"float": ctypes.c_float, "int": ctypes.c_int,
                          "long long": ctypes.c_longlong}[
                param.rsplit(" ", 1)[0].removeprefix("const ")])
    return kinds


@pytest.mark.parametrize("loader", ["_adagrad_kernel", "_novograd_kernel"])
def test_ctypes_signatures_match_the_c_functions(monkeypatch, loader):
    """The argument types the loaders hand ``_build.function`` (nothing is
    built) against the C definitions of apex_adagrad and apex_novograd."""
    monkeypatch.setattr(_build, "function", lambda lib, symbol, types: (
        lib, symbol, list(types)))
    lib, symbol, types = getattr(optim, loader).__wrapped__()
    assert types == _c_argtypes(lib, symbol)


@pytest.mark.parametrize("src,pointer_lists", [("adagrad.cu", 4),
                                               ("novograd.cu", 5)])
def test_launch_tables_fit_the_parameter_limit(src, pointer_lists):
    """Each kernel's table (pointers, sizes, prefix chunk counts, int heads,
    the count) with its other parameters under the 4 KB limit; the walk's
    constants are the ones the wrappers and the model take."""
    text = (_CSRC / src).read_text()

    def constant(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             text).group(1))

    n = constant("kMaxTensors")
    assert n == optim.MAX_TENSORS
    assert (constant("kThreads"), constant("kUnroll")) == (THREADS, UNROLL)
    table = pointer_lists * 8 * n + 8 * n + 8 * (n + 1) + 4 * n + 8
    others = 48 + 5 * 8  # the hyper-parameters and the device pointers
    assert table + others < 4096, table


# ------------------------------------------- the JAX state carried over

class _Scoped(torch.nn.Module):
    """Parameters registered as zeta.w, alpha.w, then transformer.layers.
    <i>.w for i < 11: JAX's leaf order of the same tree (keys sorted:
    alpha, transformer.layer_0, layer_1, layer_10, layer_2, ..., zeta)
    is another order."""

    def __init__(self, tree):
        super().__init__()
        self.zeta = torch.nn.ParameterDict({"w": tree["zeta"]["w"]})
        self.alpha = torch.nn.ParameterDict({"w": tree["alpha"]["w"]})
        self.transformer = torch.nn.Module()
        self.transformer.layers = torch.nn.ModuleList(
            torch.nn.ParameterDict({"w": tree["transformer"][f"layer_{i}"][
                "w"]}) for i in range(11))


def _scoped_tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)

    def leaf(n):
        return (rng.randn(n) * scale).astype(np.float32)

    return {"zeta": {"w": leaf(3)}, "alpha": {"w": leaf(5)},
            "transformer": {f"layer_{i}": {"w": leaf(2 + i)}
                            for i in range(11)}}


def _carried(jopt, make, jit):
    """Two JAX steps on the scoped tree, the state carried into the
    port's optimizer over a model of the JAX parameters, then one more
    step on each: (port model, JAX params after the third step)."""
    from apex_tpu_torch.models.params import load_jax_optimizer_state
    jp = jax.tree.map(jnp.asarray, _scoped_tree(90))
    js = jopt.init(jp)
    step = jax.jit(jopt.step) if jit else jopt.step
    for seed in (91, 92):
        jp, js = step(jax.tree.map(jnp.asarray, _scoped_tree(seed)), js, jp)
    model = _Scoped(jax.tree.map(
        lambda a: torch.nn.Parameter(torch.from_numpy(np.array(a))), jp))
    names = [n for n, _ in model.named_parameters()]
    assert names[:2] == ["zeta.w", "alpha.w"]
    topt = make(model.parameters())
    load_jax_optimizer_state(topt, model, jax.tree.map(np.asarray, js))
    assert int(topt.param_groups[0]["step"]) == 2
    g = _scoped_tree(93)
    jp, js = step(jax.tree.map(jnp.asarray, g), js, jp)
    model.zeta.w.grad = torch.from_numpy(g["zeta"]["w"])
    model.alpha.w.grad = torch.from_numpy(g["alpha"]["w"])
    for i, layer in enumerate(model.transformer.layers):
        layer.w.grad = torch.from_numpy(g["transformer"][f"layer_{i}"]["w"])
    topt.step()
    return model, jp


def _by_port_name(jp):
    out = {"zeta.w": jp["zeta"]["w"], "alpha.w": jp["alpha"]["w"]}
    for i in range(11):
        out[f"transformer.layers.{i}.w"] = jp["transformer"][f"layer_{i}"][
            "w"]
    return out


def test_load_jax_novograd_state_maps_the_second_moments_by_leaf_path():
    """FusedNovoGrad's exp_avg_sq is one vector in JAX's leaf order; the
    carry puts each value at its parameter's position in the port's
    order (which differs here), so the next step equals JAX's jitted one
    (within RTOL/ATOL: the norms' order)."""
    kw = dict(lr=0.01, weight_decay=0.01)
    model, jp = _carried(JaxFusedNovoGrad(**kw),
                         lambda ps: FusedNovoGrad(ps, **kw), jit=True)
    want = _by_port_name(jp)
    for n, p in model.named_parameters():
        _close([p], [want[n]], n)


def test_load_jax_novograd_state_in_registration_order_would_differ():
    """The mapping is needed: the JAX vector taken in the port's order
    moves the parameters elsewhere than JAX's step."""
    from apex_tpu_torch.models.params import _leaf_names, from_jax_name
    order = [from_jax_name(n) for n in _leaf_names(_scoped_tree(0))]
    model = _Scoped(jax.tree.map(
        lambda a: torch.nn.Parameter(torch.from_numpy(a)), _scoped_tree(0)))
    assert order != [n for n, _ in model.named_parameters()]
    assert sorted(order) == sorted(n for n, _ in model.named_parameters())


def test_load_jax_adagrad_state_continues_the_jax_trajectory():
    """FusedAdagrad's sums carried by name: the next step equals JAX's,
    bit for bit."""
    kw = dict(lr=0.05, weight_decay=0.01)
    model, jp = _carried(JaxFusedAdagrad(**kw),
                         lambda ps: FusedAdagrad(ps, **kw), jit=False)
    want = _by_port_name(jp)
    for n, p in model.named_parameters():
        _equal([p], [want[n]], n)


# ---------------------------------------- the launches, on the CPU

@pytest.fixture
def recorded(monkeypatch):
    """The C functions replaced by recorders; CUDA contexts and streams by
    stand-ins, so the launch code runs on CPU tensors."""
    import contextlib

    from apex_tpu_torch.kernels import _checks
    calls = []

    def recorder(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(optim, "_adagrad_kernel", lambda: recorder)
    monkeypatch.setattr(optim, "_novograd_kernel", lambda: recorder)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    return calls


def _lists(n, size=70001):
    return [[torch.zeros(size) for _ in range(n)] for _ in range(3)]


def test_adagrad_launch_tables(recorded):
    """``launch_adagrad`` makes a launch per 64 tensors of one dtype pair,
    each with the tables' pointers, the heads of adam_plan and the
    hyper-parameters in the C order; no scale is a null pointer."""
    gs, ps, hs = _lists(70)
    gs[3] = gs[3].bfloat16()
    n = optim.launch_adagrad(torch.zeros(1), gs, ps, hs, None, lr=0.1,
                             eps=1e-10, weight_decay=0.01, mode=1)
    assert n == len(recorded) == 3  # 69 fp32 (64 + 5) and 1 bf16 gradient
    assert sorted(call[6] for call in recorded) == [1, 5, 64]
    for call in recorded:
        heads = list(call[5])[:call[6]]
        assert all(h in (0, 1, 2, 3, 70001) for h in heads)
        assert call[10] is None  # no scale
        assert (call[11], call[13], call[14]) == (pytest.approx(0.1),
                                                  pytest.approx(0.01), 1)


def test_novograd_launch_tables_and_scratch(recorded):
    """``launch_novograd`` hands each tensor's v pointer (v's base plus
    its slot), a zeroed scratch of a partial a chunk and the count, the
    norm code (2 or 0) and the step's pointer."""
    gs, ps, ms = _lists(66, 9000)
    v = torch.zeros(80)
    slots = list(range(79, 13, -1))
    n = optim.launch_novograd(torch.zeros(1), gs, ps, ms, v, None,
                              slots=slots,
                              step=torch.ones(1, dtype=torch.int32), lr=0.1,
                              b1=0.9, b2=0.98, beta3=0.1, eps=1e-8,
                              weight_decay=0.0, moment_mode=1,
                              norm_type=float("inf"), init_zero=True,
                              bias_correction=True)
    assert n == len(recorded) == 2
    at = 0
    for call in recorded:
        count = call[7]
        vs = list(call[4])[:count]
        assert vs == [v.data_ptr() + 4 * s for s in slots[at:at + count]]
        assert call[14] == optim.novograd_scratch([9000] * count)
        assert call[14] - 1 >= count * 3  # 9000 elements: 3 chunks each
        assert call[23] == 0 and call[24] == 1  # the max norm, init_zero
        at += count
