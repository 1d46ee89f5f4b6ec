"""apex_tpu_torch Adam and LAMB (kernels/optim, ops/multi_tensor,
optimizers FusedAdam and FusedLAMB, models/params
load_jax_optimizer_state) against apex_tpu's on the CPU.

The port's wrappers take their plain PyTorch versions for CPU tensors;
the JAX side runs ``apex_tpu.kernels.optim.fused_adam_update`` and
``fused_lamb_mvu`` as Pallas kernels in interpret mode, and
``multi_tensor_adam`` / ``multi_tensor_lamb`` / ``FusedAdam`` /
``FusedLAMB`` as the jnp code the JAX optimizers run. Inputs come from
numpy seeds.

Tolerances: the Adam update and LAMB's moments and raw update are the
same fp32 operations in the same order, elementwise with no sums, so
results are compared for equality where the JAX side is the kernel or
the op run eagerly; the jit-compiled JAX optimizers may contract their
expressions differently, so trajectories over several steps are held
within 1e-6 relative (a few fp32 ulps). LAMB's norms (the global
gradient norm, each tensor's ||p|| and ||update||) are sums in another
order, so ``multi_tensor_lamb`` and ``FusedLAMB`` are held within 1e-6
relative plus 1e-7 absolute too (measured: parameters of magnitude ~1
within 2.4e-7 absolute, one or two fp32 ulps).

The streaming Adam body's plan (``kernels/optim.py`` ``adam_plan``: a
scalar head, float4 vectors, a scalar tail per tensor) and a model of
its chunk walk (``csrc/adam.cu`` ``adam_vec_kernel``) are checked to
cover every element exactly once.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import optim as jax_optim
from apex_tpu.kernels.registry import get_kernel_registry
from apex_tpu.ops import multi_tensor_adam as jax_multi_tensor_adam
from apex_tpu.ops import multi_tensor_l2norm as jax_multi_tensor_l2norm
from apex_tpu.ops import multi_tensor_lamb as jax_multi_tensor_lamb
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import FusedLAMB as JaxFusedLAMB
from apex_tpu_torch.kernels import optim as port_kernels
from apex_tpu_torch.kernels import registry
from apex_tpu_torch.models.params import load_jax_optimizer_state
from apex_tpu_torch.ops.multi_tensor import (
    bias_corrections,
    multi_tensor_adam,
    multi_tensor_l2norm,
    multi_tensor_lamb,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(4, 5), (7,), (3, 2, 6), (1,)]


@pytest.fixture(autouse=True)
def _interpret():
    reg = get_kernel_registry()
    reg.force_interpret(True, ["adam", "lamb"])
    yield
    reg.force_interpret(False, ["adam", "lamb"])


def _arrays(seed, shapes=SHAPES):
    """g, p, m, v lists of fp32 numpy arrays (v >= 0)."""
    rng = np.random.RandomState(seed)
    g = [rng.randn(*s).astype(np.float32) for s in shapes]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    m = [0.1 * rng.randn(*s).astype(np.float32) for s in shapes]
    v = [0.01 * rng.rand(*s).astype(np.float32) for s in shapes]
    return g, p, m, v


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_update_plain_matches_jax_kernel(adam_w, wd):
    g, p, m, v = (np.concatenate([a.ravel() for a in t])
                  for t in _arrays(1))
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
              adam_w=adam_w)
    bc1, bc2 = bias_corrections(0.9, 0.999, 3)
    want = jax_optim.fused_adam_update(
        jnp.asarray(g), jnp.asarray(p), jnp.asarray(m), jnp.asarray(v),
        bc1=bc1, bc2=bc2, **kw)
    got = port_kernels.fused_adam_update_plain(
        torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(m),
        torch.from_numpy(v), bc1=torch.tensor(bc1), bc2=torch.tensor(bc2),
        **kw)
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_bias_corrections_match_jnp():
    """``1 - beta**step`` as jnp computes it from an int32 step."""
    steps = jnp.arange(1, 101, dtype=jnp.int32)
    for b1, b2 in ((0.9, 0.999), (0.8, 0.95)):
        want1 = np.asarray(1.0 - b1 ** steps)
        want2 = np.asarray(1.0 - b2 ** steps)
        got = np.array([bias_corrections(b1, b2, s) for s in range(1, 101)],
                       dtype=np.float32)
        np.testing.assert_array_equal(got[:, 0], want1)
        np.testing.assert_array_equal(got[:, 1], want2)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("step", [1, 4])
def test_multi_tensor_adam_matches_jax(mode, wd, bias_correction, step):
    g, p, m, v = _arrays(2)
    want_p, want_m, want_v, _ = jax_multi_tensor_adam(
        jnp.zeros((), jnp.float32),
        [[jnp.asarray(a) for a in t] for t in (g, p, m, v)],
        1e-3, 0.9, 0.999, 1e-8, jnp.asarray(step, jnp.int32), mode,
        bias_correction, wd)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    multi_tensor_adam(torch.zeros(1), [_torch(g), tp, tm, tv], 1e-3, 0.9,
                      0.999, 1e-8, step, mode, bias_correction, wd)
    for got, want in ((tp, want_p), (tm, want_m), (tv, want_v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_noop_flag_leaves_state_bit_identical():
    g, p, m, v = _arrays(3)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    multi_tensor_adam(torch.ones(1), [_torch(g), tp, tm, tv], 1e-3, 0.9,
                      0.999, 1e-8, 1, 1, True, 0.01)
    for got, want in ((tp, p), (tm, m), (tv, v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), w)


def test_multi_tensor_adam_rejects_bad_mode():
    with pytest.raises(ValueError, match="mode"):
        multi_tensor_adam(torch.zeros(1), [[], [], [], []], 1e-3, 0.9,
                          0.999, 1e-8, 1, 2, True, 0.0)


def _jax_trajectory(p0, grads, **kw):
    """Params after each step of the JAX FusedAdam fed ``grads``."""
    opt = JaxFusedAdam(**kw)
    params = {f"t{i}": jnp.asarray(a) for i, a in enumerate(p0)}
    state = opt.init(params)
    step = jax.jit(opt.step)
    out = []
    for gs in grads:
        params, state = step({f"t{i}": jnp.asarray(a)
                              for i, a in enumerate(gs)}, state, params)
        out.append([np.asarray(params[f"t{i}"]) for i in range(len(p0))])
    return out, state


@pytest.mark.parametrize("adam_w_mode,wd", [(True, 0.0), (True, 0.01),
                                             (False, 0.01)])
def test_fused_adam_trajectory_matches_jax(adam_w_mode, wd):
    _, p0, _, _ = _arrays(4)
    grads = [_arrays(10 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, adam_w_mode=adam_w_mode,
              weight_decay=wd)
    want, _ = _jax_trajectory(p0, grads, **kw)
    params = [torch.nn.Parameter(t) for t in _torch(p0)]
    opt = FusedAdam(params, **kw)
    for k, gs in enumerate(grads):
        for prm, gr in zip(params, gs):
            prm.grad = torch.from_numpy(gr)
        opt.step()
        opt.zero_grad()
        for prm, w in zip(params, want[k]):
            np.testing.assert_allclose(prm.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-7)
    assert opt.param_groups[0]["step"] == 3
    assert all(prm.grad is None for prm in params)


def test_load_jax_adam_state_continues_the_jax_trajectory():
    """The port's optimizer started from the JAX state after two steps
    takes the JAX optimizer's third step."""
    _, p0, _, _ = _arrays(5)
    grads = [_arrays(20 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01)
    want, _ = _jax_trajectory(p0, grads, **kw)
    _, state = _jax_trajectory(p0, grads[:2], **kw)
    model = torch.nn.ParameterDict(
        {f"t{i}": torch.nn.Parameter(torch.from_numpy(a.copy()))
         for i, a in enumerate(want[1])})
    opt = FusedAdam(model.parameters(), **kw)
    load_jax_optimizer_state(opt, model, jax.tree.map(np.asarray, state))
    assert opt.param_groups[0]["step"] == 2
    for i, gr in enumerate(grads[2]):
        model[f"t{i}"].grad = torch.from_numpy(gr)
    opt.step()
    for i, w in enumerate(want[2]):
        np.testing.assert_allclose(model[f"t{i}"].detach().numpy(), w,
                                   rtol=1e-6, atol=1e-7)


def test_load_jax_adam_state_rejects_other_names():
    model = torch.nn.ParameterDict({"a": torch.nn.Parameter(torch.zeros(3))})
    opt = FusedAdam(model.parameters())
    state = {"step": np.int32(1), "exp_avg": {"b": np.zeros(3, np.float32)},
             "exp_avg_sq": {"b": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="do not match"):
        load_jax_optimizer_state(opt, model, state)


def test_fused_adam_refuses_what_it_does_not_have():
    """AMSGrad raises, as in JAX; amp's master weights, found_inf and
    scale are honoured (tests/test_torch_amp_optim.py holds them to JAX):
    a found_inf step changes nothing, its step count included."""
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)
    FusedAdam(p, master_weights=True)
    opt = FusedAdam(p)
    p[0].grad = torch.ones(3)
    opt.step(found_inf=torch.ones(1))
    assert torch.equal(p[0].detach(), torch.zeros(3))
    assert int(opt.param_groups[0]["step"]) == 0
    opt.step(scale=128.0)
    assert int(opt.param_groups[0]["step"]) == 1
    assert not torch.equal(p[0].detach(), torch.zeros(3))


@pytest.mark.parametrize("opt_cls", [FusedAdam, FusedLAMB])
def test_step_count_is_one_device_tensor_and_matches_the_host_op(opt_cls):
    """Every step reads the group's count as a one-element int32 tensor on
    the parameters' device, converted once from a number set on the group
    (as a loaded state sets it); the step it takes, with the kernels' bias
    corrections from that tensor, equals the op on the host's corrections
    for the int count, bit for bit."""
    g, p, m, v = (_torch(t) for t in _arrays(41))
    params = [torch.nn.Parameter(t.clone()) for t in p]
    opt = opt_cls(params, lr=1e-2, weight_decay=0.01)
    opt.param_groups[0]["step"] = 6
    for prm, gr, mm, vv in zip(params, g, m, v):
        prm.grad = gr.clone()
        opt.state[prm].update(exp_avg=mm.clone(), exp_avg_sq=vv.clone())
    opt.step()
    step = opt.param_groups[0]["step"]
    assert (step.dtype, step.shape, int(step)) == (torch.int32, (1,), 7)
    want = [t.clone() for t in p]
    ms, vs = [t.clone() for t in m], [t.clone() for t in v]
    gs = [t.clone() for t in g]
    if opt_cls is FusedAdam:
        multi_tensor_adam(torch.zeros(1), [gs, want, ms, vs], 1e-2, 0.9,
                          0.999, 1e-8, 7, 1, True, 0.01)
    else:
        norm, _ = multi_tensor_l2norm(torch.zeros(1), [gs])
        multi_tensor_lamb(torch.zeros(1), [gs, want, ms, vs], 1e-2, 0.9,
                          0.999, 1e-6, 7, True, 0.01, True, 1, norm, 1.0)
    for prm, w, mm, vv in zip(params, want, ms, vs):
        state = opt.state[prm]
        assert torch.equal(prm.detach(), w)
        assert torch.equal(state["exp_avg"], mm)
        assert torch.equal(state["exp_avg_sq"], vv)


def test_fused_adam_skips_parameters_without_grad():
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    opt = FusedAdam([a, b], lr=0.1)
    a.grad = torch.ones(3)
    opt.step()
    assert not torch.equal(a.detach(), torch.ones(3))
    assert torch.equal(b.detach(), torch.ones(2)) and b not in opt.state


def test_plain_version_counts_no_launch():
    registry.reset()
    g, p, m, v = (_torch(t) for t in _arrays(6))
    multi_tensor_adam(torch.zeros(1), [g, p, m, v], 1e-3, 0.9, 0.999, 1e-8,
                      1, 1, True, 0.0)
    assert registry.launches()["adam"] == 0


def test_wrapper_checks_lists_and_devices():
    g, p, m, v = (_torch(t) for t in _arrays(7))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.adam(torch.zeros(1, device="meta"), g, p, m, v,
                          lr=1e-3, bc1=1.0, bc2=1.0, b1=0.9, b2=0.999,
                          eps=1e-8, weight_decay=0.0, adam_w=True)


# --------------------------------- the streaming Adam body's plan (#12)

_ADAM_SOURCE = (Path(port_kernels.__file__).resolve().parent.parent / "csrc"
                / "adam.cu")


@pytest.mark.parametrize("size", [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17,
                                  64, 65539])
@pytest.mark.parametrize("offsets", [(0,) * 4, (4,) * 4, (8,) * 4,
                                     (12,) * 4, (0, 4, 0, 0),
                                     (8, 8, 8, 12)])
def test_adam_plan_covers_every_element_once(size, offsets):
    """head, vectors * 4 and tail partition the tensor; 16-byte accesses
    only where the four arrays are aligned alike, starting on the
    boundary; the kernel's scalar index q (element q below the head, q +
    4 * vectors past it) reaches the head and tail elements once."""
    span = port_kernels.adam_plan(size, offsets)
    assert span.head + 4 * span.vectors + span.tail == size
    assert min(span) >= 0
    if len(set(offsets)) == 1:
        assert span.head <= 3 and span.tail <= 3
        assert span.vectors == 0 or (offsets[0] + 4 * span.head) % 16 == 0
        assert span.vectors == (size - span.head) // 4
    else:
        assert span == (size, 0, 0)
    scalars = range(size - 4 * span.vectors)
    elems = [q if q < span.head else q + 4 * span.vectors for q in scalars]
    elems += range(span.head, span.head + 4 * span.vectors)
    assert sorted(elems) == list(range(size))


def _walk(sizes, heads, threads, unroll, grid):
    """A model of adam_vec_kernel's walk (csrc/adam.cu) with small
    blocks: each tensor's chunks are the larger of its vectors over
    threads * unroll and its scalar elements over four times that; each
    block walks the chunks grid-stride. Returns each element's visits."""
    chunk = threads * unroll
    first = [0]
    for size, head in zip(sizes, heads):
        vecs, scal = (size - head) // 4, size - 4 * ((size - head) // 4)
        first.append(first[-1] + max(-(-vecs // chunk),
                                     -(-scal // (4 * chunk))))
    hits = [[0] * size for size in sizes]
    for block in range(grid):
        k = 0
        for c in range(block, first[-1], grid):
            while first[k + 1] <= c:
                k += 1
            local, size, head = c - first[k], sizes[k], heads[k]
            vecs = (size - head) // 4
            for t in range(threads):
                for u in range(unroll):
                    i = local * chunk + t + u * threads
                    if i < vecs:
                        for e in range(4):
                            hits[k][head + 4 * i + e] += 1
                end = min((local + 1) * 4 * chunk, size - 4 * vecs)
                for q in range(local * 4 * chunk + t, end, threads):
                    hits[k][q if q < head else q + 4 * vecs] += 1
    return hits


@pytest.mark.parametrize("threads,unroll,grid", [(4, 2, 3), (2, 1, 1),
                                                 (8, 4, 5)])
def test_adam_walk_visits_every_element_once(threads, unroll, grid):
    rng = np.random.RandomState(threads + grid)
    sizes = [int(n) for n in rng.choice([0, 1, 3, 5, 33, 64, 130, 257], 12)]
    offsets = [int(o) for o in rng.choice([0, 4, 8, 12], 12)]
    heads = [port_kernels.adam_plan(n, (o,) * 4 if k % 3 else (o, 0, 0, 0)
                                    ).head
             for k, (n, o) in enumerate(zip(sizes, offsets))]
    hits = _walk(sizes, heads, threads, unroll, grid)
    assert all(h == 1 for hs in hits for h in hs)


def test_adam_plan_heads_from_views():
    """The wrapper's heads for views at 4-, 8- and 12-byte offsets into
    flat buffers, as the kernel reads them (``_runs``' ``heads``)."""
    flats = [torch.zeros(64) for _ in range(4)]
    run = [[f[k:k + 9] for k in (0, 1, 2, 3)] for f in flats]
    run[0][3] = flats[0][4:13]  # g's view 4 bytes further on than p's
    assert [f.data_ptr() % 16 for f in flats] == [0] * 4
    lists = dict(zip("gpmv", run), out=[None] * 4)
    (*_, heads, _), = port_kernels._runs(lists, ("g", "p", "out"))
    assert list(heads()) == [0, 3, 2, 9]


def test_adam_runs_match_the_kernel_table():
    """One launch takes at most kMaxTensors tensors of one dtype
    combination: 179 make three runs of 64, 64 and 51 (empty runs launch
    nothing)."""
    src = _ADAM_SOURCE.read_text()
    assert int(re.search(r"constexpr int kMaxTensors = (\d+);", src).group(1)
               ) == port_kernels.MAX_TENSORS

    def runs(ts):
        lists = dict(g=ts, p=ts, m=ts, v=ts, out=[None] * len(ts))
        return [n for *_, n in port_kernels._runs(lists, ("g", "p", "out"))]

    assert runs([torch.zeros(3) for _ in range(179)]) == [64, 64, 51]
    assert runs([torch.zeros(0) for _ in range(70)]) == []


def test_adam_path_codes_match_the_kernel_source():
    """apex_adam's path argument: 0 the first design, 1 the streaming
    body (the wrapper's), 2 to 5 its planted faults."""
    src = _ADAM_SOURCE.read_text()
    assert (port_kernels.ADAM_FIRST, port_kernels.ADAM_STREAM) == (0, 1)
    assert (port_kernels.ADAM_RECIPROCAL, port_kernels.ADAM_TAIL_UNWRITTEN,
            port_kernels.ADAM_STEP_BEFORE,
            port_kernels.ADAM_OUT_UNWRITTEN) == (2, 3, 4, 5)
    assert "return g_dtype == mt::kFloat32 ? launch_by_p<float>(" in src
    assert re.search(r"case 2: return launch_vec<float, float, mt::None, "
                     r"kReciprocal>", src)
    assert re.search(r"case 3: return launch_vec<float, float, mt::None, "
                     r"kTailUnwritten>", src)
    assert re.search(r"case 4: return launch_vec<bf16, float, bf16, "
                     r"kStepBefore>", src)
    assert re.search(r"case 5: return launch_vec<bf16, float, bf16, "
                     r"kOutUnwritten>", src)
    assert "adam_kernel<<<" in src
    assert re.search(r"path < 0 \|\| path > 5 \|\| noop == nullptr\)\s+"
                     r"return -1", src)


# -------------------------------------------------------------------- LAMB

@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("grad_averaging", [True, False])
def test_fused_lamb_mvu_plain_matches_jax_kernel(adam_w, wd, grad_averaging):
    """Against the interpreted Pallas kernel within 4 fp32 ulps (XLA's
    CPU compiler contracts the kernel's ``b1 * m + beta3 * g`` into an
    FMA: measured 18 of 64 moments one ulp apart, and updates up to two
    ulps apart after ``+ wd * p``), and against the same
    JAX function with its gate off (its jnp oracle, run op by op, which
    the CUDA kernel's round-to-nearest intrinsics follow) for equality."""
    g, p, m, v = (np.concatenate([a.ravel() for a in t])
                  for t in _arrays(31))
    beta3 = 0.1 if grad_averaging else 1.0
    kw = dict(b1=0.9, b2=0.999, beta3=beta3, eps=1e-6, weight_decay=wd,
              adam_w=adam_w)
    bc1, bc2 = bias_corrections(0.9, 0.999, 2)
    args = [jnp.asarray(a) for a in (g, p, m, v)]
    want = jax_optim.fused_lamb_mvu(*args, bc1=bc1, bc2=bc2, **kw)
    got = port_kernels.fused_lamb_mvu_plain(
        torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(m),
        torch.from_numpy(v), bc1=torch.tensor(bc1), bc2=torch.tensor(bc2),
        **kw)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=2.0 ** -21,
                                   atol=0)
    get_kernel_registry().force_interpret(False, ["lamb"])
    oracle = jax_optim.fused_lamb_mvu(*args, bc1=jnp.float32(bc1),
                                      bc2=jnp.float32(bc2), **kw)
    for t, w in zip(got, oracle):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_lamb_plain_clips_writes_the_update_into_g_and_honours_noop():
    g, p, m, v = _arrays(32)
    kw = dict(bc1=0.1, bc2=0.001, b1=0.9, b2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, adam_w=True)
    clip = torch.tensor([2.5])
    tg, tm, tv = _torch(g), _torch(m), _torch(v)
    port_kernels.lamb(torch.zeros(1), tg, _torch(p), tm, tv, clip=clip, **kw)
    for k in range(len(g)):
        want = port_kernels.fused_lamb_mvu_plain(
            torch.from_numpy(g[k]) / clip[0], torch.from_numpy(p[k]),
            torch.from_numpy(m[k]), torch.from_numpy(v[k]),
            **dict(kw, bc1=torch.tensor(0.1), bc2=torch.tensor(0.001)))
        for got, w in zip((tm[k], tv[k], tg[k]), want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
    tg, tm, tv = _torch(g), _torch(m), _torch(v)
    port_kernels.lamb(torch.ones(1), tg, _torch(p), tm, tv, clip=clip, **kw)
    for got, want in ((tg, g), (tm, m), (tv, v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), w)


def test_multi_tensor_l2norm_matches_jax():
    xs = _arrays(33)[0]
    want, want_per = jax_multi_tensor_l2norm(
        jnp.zeros((), jnp.float32), [[jnp.asarray(a) for a in xs]], True)
    got, got_per = multi_tensor_l2norm(torch.zeros(1), [_torch(xs)], True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got_per.numpy(), np.asarray(want_per),
                               rtol=1e-6)
    assert multi_tensor_l2norm(torch.zeros(1), [_torch(xs)])[1] is None


# (mode, weight_decay, use_nvlamb, max_grad_norm): the grads' global norm
# is ~8, so 1.0 clips and 100.0 does not
LAMB_CASES = [(1, 0.01, False, 1.0), (1, 0.01, False, 100.0),
              (0, 0.01, False, 1.0), (1, 0.0, False, 1.0),
              (1, 0.0, True, 1.0), (0, 0.0, True, 100.0), (1, 0.01, True, 0.0)]


@pytest.mark.parametrize("mode,wd,nvlamb,max_norm", LAMB_CASES)
@pytest.mark.parametrize("step", [1, 3])
def test_multi_tensor_lamb_matches_jax(mode, wd, nvlamb, max_norm, step):
    g, p, m, v = _arrays(34)
    gnorm = float(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for a in g)))
    want_p, want_m, want_v, _ = jax_multi_tensor_lamb(
        jnp.zeros((), jnp.float32),
        [[jnp.asarray(a) for a in t] for t in (g, p, m, v)],
        1e-2, 0.9, 0.999, 1e-6, jnp.asarray(step, jnp.int32), True, wd,
        True, mode, jnp.float32(gnorm), max_norm, nvlamb)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    multi_tensor_lamb(torch.zeros(1), [_torch(g), tp, tm, tv], 1e-2, 0.9,
                      0.999, 1e-6, step, True, wd, True, mode,
                      torch.tensor(gnorm), max_norm, nvlamb)
    for got, want in ((tm, want_m), (tv, want_v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    for t, w in zip(tp, want_p):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_multi_tensor_lamb_noop_leaves_everything_bit_identical():
    g, p, m, v = _arrays(35)
    g[0][0, 0] = np.inf  # an overflowed step: skipped, not NaN-poisoned
    lists = [_torch(t) for t in (g, p, m, v)]
    multi_tensor_lamb(torch.ones(1), lists, 1e-2, 0.9, 0.999, 1e-6, 1, True,
                      0.01, True, 1, torch.tensor(8.0), 1.0, False)
    for got, want in zip(lists, (g, p, m, v)):
        for t, w in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), w)


def _jax_lamb_trajectory(p0, grads, **kw):
    """Params after each step of the JAX FusedLAMB fed ``grads``."""
    opt = JaxFusedLAMB(**kw)
    params = {f"t{i}": jnp.asarray(a) for i, a in enumerate(p0)}
    state = opt.init(params)
    step = jax.jit(opt.step)
    out = []
    for gs in grads:
        params, state = step({f"t{i}": jnp.asarray(a)
                              for i, a in enumerate(gs)}, state, params)
        out.append([np.asarray(params[f"t{i}"]) for i in range(len(p0))])
    return out, state


FUSED_LAMB_CASES = [
    dict(adam_w_mode=True, weight_decay=0.01, max_grad_norm=1.0),
    dict(adam_w_mode=True, weight_decay=0.01, max_grad_norm=100.0),
    dict(adam_w_mode=False, weight_decay=0.01, max_grad_norm=1.0),
    dict(adam_w_mode=True, weight_decay=0.0, max_grad_norm=1.0),
    dict(adam_w_mode=True, weight_decay=0.0, use_nvlamb=True),
    dict(adam_w_mode=False, weight_decay=0.0, max_grad_norm=100.0,
         use_nvlamb=True),
    dict(adam_w_mode=True, weight_decay=0.01, bias_correction=False,
         grad_averaging=False),
]


@pytest.mark.parametrize("kw", FUSED_LAMB_CASES)
def test_fused_lamb_trajectory_matches_jax(kw):
    _, p0, _, _ = _arrays(36)
    grads = [_arrays(40 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-6, **kw)
    want, _ = _jax_lamb_trajectory(p0, grads, **kw)
    params = [torch.nn.Parameter(t) for t in _torch(p0)]
    opt = FusedLAMB(params, **kw)
    for k, gs in enumerate(grads):
        for prm, gr in zip(params, gs):
            prm.grad = torch.from_numpy(gr.copy())
        opt.step()
        opt.zero_grad()
        for prm, w in zip(params, want[k]):
            np.testing.assert_allclose(prm.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-7)
    assert opt.param_groups[0]["step"] == 3
    assert all(prm.grad is None for prm in params)


def test_fused_lamb_leaves_the_update_in_grad_until_zero_grad():
    p = torch.nn.Parameter(torch.ones(4))
    opt = FusedLAMB([p], lr=0.1, set_grad_none=False)
    g = torch.tensor([1.0, -2.0, 0.5, 0.0])
    p.grad = g.clone()
    opt.step()
    assert not torch.equal(p.grad, g)  # the raw update, not the gradient
    opt.zero_grad()
    assert torch.equal(p.grad, torch.zeros(4))


def test_load_jax_optimizer_state_continues_the_jax_lamb_trajectory():
    """The port's FusedLAMB started from the JAX state after two steps
    takes the JAX optimizer's third step."""
    _, p0, _, _ = _arrays(37)
    grads = [_arrays(50 + k)[0] for k in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-6, weight_decay=0.01)
    want, _ = _jax_lamb_trajectory(p0, grads, **kw)
    _, state = _jax_lamb_trajectory(p0, grads[:2], **kw)
    model = torch.nn.ParameterDict(
        {f"t{i}": torch.nn.Parameter(torch.from_numpy(a.copy()))
         for i, a in enumerate(want[1])})
    opt = FusedLAMB(model.parameters(), **kw)
    load_jax_optimizer_state(opt, model, jax.tree.map(np.asarray, state))
    assert opt.param_groups[0]["step"] == 2
    for i, gr in enumerate(grads[2]):
        model[f"t{i}"].grad = torch.from_numpy(gr.copy())
    opt.step()
    for i, w in enumerate(want[2]):
        np.testing.assert_allclose(model[f"t{i}"].detach().numpy(), w,
                                   rtol=1e-6, atol=1e-7)


def test_fused_lamb_refuses_what_it_does_not_have():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(p, amsgrad=True)
    opt = FusedLAMB(p)
    p[0].grad = torch.ones(3)
    opt.step(found_inf=torch.ones(1))  # honoured: nothing changes
    assert torch.equal(p[0].detach(), torch.zeros(3))
    assert int(opt.param_groups[0]["step"]) == 0
    opt.step(scale=128.0)
    assert int(opt.param_groups[0]["step"]) == 1
    with pytest.raises(ValueError, match="mode"):
        multi_tensor_lamb(torch.zeros(1), [[], [], [], []], 1e-3, 0.9, 0.999,
                          1e-6, 1, True, 0.0, True, 2, 1.0, 1.0)


def test_lamb_plain_version_counts_no_launch():
    registry.reset()
    g, p, m, v = (_torch(t) for t in _arrays(38))
    multi_tensor_lamb(torch.zeros(1), [g, p, m, v], 1e-3, 0.9, 0.999, 1e-6,
                      1, True, 0.01, True, 1, torch.tensor(3.0), 1.0)
    assert registry.launches()["lamb"] == 0


def test_lamb_wrapper_checks_devices():
    g, p, m, v = (_torch(t) for t in _arrays(39))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        port_kernels.lamb(torch.zeros(1, device="meta"), g, p, m, v,
                          clip=None, bc1=1.0, bc2=1.0, b1=0.9, b2=0.999,
                          beta3=0.1, eps=1e-6, weight_decay=0.0, adam_w=True)
