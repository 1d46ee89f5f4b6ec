"""Multi-tensor Adam/AdamW update, LAMB's two stages, SGD, Adagrad and
NovoGrad: the CUDA kernels (csrc/adam.cu, csrc/lamb.cu, csrc/sgd.cu,
csrc/adagrad.cu, csrc/novograd.cu) and their plain PyTorch versions.

Counterparts of ``apex_tpu/kernels/optim.py`` ``fused_adam_update`` and
``fused_lamb_mvu``, which update one flat fp32 buffer per call. Here one
launch updates a list of up to :data:`MAX_TENSORS` tensors in place, as
the reference's ``multi_tensor_apply`` does, and :func:`adam`,
:func:`lamb`, :func:`lamb_stage2`, :func:`sgd`, :func:`adagrad` and
:func:`novograd` make as many launches as the list needs: one per
:data:`MAX_TENSORS` tensors of one dtype combination (and, for
:func:`lamb`, of one weight decay). The entry points are the ops of
:mod:`apex_tpu_torch.ops.multi_tensor`.

One body serves every step of each optimizer. The gradients are fp32 or
bf16 (widened in registers), optionally times a device ``inv_scale``;
the step skips where a device flag is > 0; the bias corrections are the
host's values or those of a device step count (the kernels compute them
from it as :func:`apex_tpu_torch.ops.multi_tensor.bias_corrections`
does), so amp's overflow-skipped step needs no host synchronisation.
Adam updates fp32 masters (or the parameters themselves) and writes the
low-precision parameters from them in the same pass; LAMB's stage 1
writes the raw update into the fp32 gradient or a buffer of its own, and
stage 2 (``p - lr * ratio * u``) writes the parameters; :func:`sgd`,
:func:`adagrad` and :func:`novograd` are JAX's ``multi_tensor_sgd``,
``multi_tensor_adagrad`` and ``multi_tensor_novograd`` (no Pallas
counterpart).
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

MAX_TENSORS = 64  # tensors in one launch's table (kMaxTensors in the .cu)
# path codes of apex_adam (csrc/adam.cu): the first design, the streaming
# body that the wrapper launches, and its planted faults (m * (1 / bc1),
# the scalar tails unwritten, the bias corrections of the step before,
# the outputs unwritten)
ADAM_FIRST, ADAM_STREAM = 0, 1
ADAM_RECIPROCAL, ADAM_TAIL_UNWRITTEN = 2, 3
ADAM_STEP_BEFORE, ADAM_OUT_UNWRITTEN = 4, 5
# path codes of apex_sgd (csrc/sgd.cu): the first design and the streaming
# body that the wrapper launches
SGD_FIRST, SGD_STREAM = 0, 1
ADAM = registry.register("adam")
LAMB = registry.register("lamb")
LAMB_STAGE2 = registry.register("lamb_stage2")
SGD = registry.register("sgd")
ADAGRAD = registry.register("adagrad")
NOVOGRAD = registry.register("novograd")
# elements of one chunk of the streaming bodies (kThreads * kUnroll
# 4-element vectors): novograd.cu's scratch holds a partial a chunk
STREAM_CHUNK = 256 * 4 * 4


def _sqrt(x):
    """The correctly rounded fp32 square root, as XLA's and CUDA's: torch's
    CPU sqrt (SLEEF, within 0.5001 ulp) rounds some values the other way;
    through float64 it is exact (a double rounding of sqrt is harmless)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def fused_adam_update_plain(g, p, m, v, *, lr, bc1, bc2, b1, b2, eps,
                            weight_decay, adam_w):
    """One Adam (``adam_w=False``: L2 decay folded into g) or AdamW update
    of fp32 tensors: returns ``(p_new, m_new, v_new)``, the body of
    ``apex_tpu``'s ``fused_adam_update`` oracle in its fp32 order.
    ``bc1`` and ``bc2`` are fp32 0-d tensors on p's device (a true
    division by them, not a multiplication by a reciprocal)."""
    if not adam_w:
        g = g + weight_decay * p
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    update = (m_new / bc1) / (_sqrt(v_new / bc2) + eps)
    if adam_w and weight_decay != 0:
        update = update + weight_decay * p
    return p - lr * update, m_new, v_new


def _unscaled(g, inv_scale):
    """g in fp32, times ``inv_scale`` (a one-element fp32 tensor, or
    None) as JAX's ``g.astype(f32) * inv_scale``."""
    g = g.float()
    return g if inv_scale is None else g * inv_scale.reshape(())


def _write(skip, old, new):
    old.copy_(torch.where(skip, old, new.to(old.dtype)))


def _corrections(device, bc1, bc2, step, b1, b2):
    """The bias corrections a step divides by, as fp32 0-d tensors on
    ``device``: those of the device ``step`` where one is given, else
    ``bc1`` and ``bc2`` (filled on the device: no host copy, so a CUDA
    graph can capture it)."""
    if step is not None:
        return device_bias_corrections(b1, b2, step)
    if bc1 is None or bc2 is None:
        raise ValueError("give the bias corrections bc1 and bc2, or a "
                         "device step")
    return tuple(torch.full((), bc, dtype=torch.float32, device=device)
                 for bc in (bc1, bc2))


def device_bias_corrections(b1, b2, step):
    """``(1 - b1**step, 1 - b2**step)`` for a device step count (an int32
    tensor of one element), as fp32 0-d tensors on its device with no
    host synchronisation: the values of :func:`apex_tpu_torch.ops.
    multi_tensor.bias_corrections` (the power of the fp32 beta in double,
    rounded to fp32, subtracted from 1 in fp32), which the device-step
    kernels compute the same way (csrc/multi_tensor.cuh)."""
    out = []
    for beta in (b1, b2):
        b = torch.tensor(beta, dtype=torch.float32).item()
        base = torch.full((), b, dtype=torch.float64, device=step.device)
        power = torch.pow(base, step.reshape(()).double())
        out.append(1.0 - power.float())
    return tuple(out)


def adam_plain(noop, gs, ps, ms, vs, outs=None, *, lr, b1, b2, eps,
               weight_decay, adam_w, bc1=None, bc2=None, step=None,
               inv_scale=None):
    """:func:`fused_adam_update_plain` over the lists, tensor by tensor:
    each g times ``inv_scale``, p (fp32 masters, or the parameters), m
    and v written in place, then each out (None: none) from the new p;
    where ``noop`` (a one-element fp32 tensor) is > 0 every tensor keeps
    its old value."""
    if not ps:
        return
    bc1, bc2 = _corrections(noop.device, bc1, bc2, step, b1, b2)
    skip = noop.reshape(()) > 0
    for g, p, m, v, out in zip(gs, ps, ms, vs, _none_list(outs, len(ps))):
        new = fused_adam_update_plain(
            _unscaled(g, inv_scale), p.float(), m.float(), v.float(), lr=lr,
            bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, adam_w=adam_w)
        for old, val in zip((p, m, v), new):
            _write(skip, old, val)
        if out is not None:
            _write(skip, out, p)


class AdamSpan(NamedTuple):
    """How a streaming body covers one tensor: ``head`` elements one at
    a time, then ``vectors`` vectors of each list (float4 of fp32 for
    Adam: 16-byte accesses), then ``tail`` elements one at a time."""
    head: int
    vectors: int
    tail: int


def adam_plan(size: int, offsets, width: int = 4) -> AdamSpan:
    """A streaming body's cover of a tensor of ``size`` elements in
    vectors of ``width`` (4 or 8) elements, whose lists start
    ``offsets`` bytes past a 16-byte boundary, counted in elements of
    ``16 // width`` bytes (:func:`_phase`; for Adam's fp32 g, p, m and v
    each ``data_ptr() % 16``): where the offsets agree, the scalar head
    runs up to the first element on the boundary and the vectors to the
    last whole vector, the tail takes the rest (size % width past the
    head); otherwise every element is head (no vector access can serve
    every list at once). The multi-tensor scale and SGD bodies
    (csrc/multi_tensor_scale.cu, csrc/sgd.cu) take the same cover."""
    unit = 16 // width
    if len(set(offsets)) != 1 or offsets[0] % unit:
        return AdamSpan(size, 0, 0)
    head = min(size, (16 - offsets[0]) % 16 // unit)
    vectors = (size - head) // width
    return AdamSpan(head, vectors, size - head - width * vectors)


def _phase(t, width=4):
    """How far ``t`` starts past a boundary of ``width`` elements, in the
    unit of :func:`adam_plan` (elements of ``16 // width`` bytes): at
    width 4 ``data_ptr() % 16`` for fp32, twice ``data_ptr() % 8`` for
    bf16; at width 8 (bf16) ``data_ptr() % 16``."""
    size = t.element_size()
    return t.data_ptr() % (width * size) // size * (16 // width)


@functools.lru_cache(maxsize=256)
def _plan_heads(ptrs, items, sizes, width=4):
    """Each tensor's scalar head for a launch, :func:`adam_plan`'s at
    ``width`` on :func:`_phase`'s offsets, from integers alone: ``ptrs``
    the data pointers of each list that the launch holds (a tuple a
    list), ``items`` each list's element size in bytes, ``sizes`` the
    tensors' elements. Where the lists' element phases agree, at e, the
    head runs to the boundary (-e % width elements); otherwise the tensor
    is all head. Cached on the pointers: a training loop's launches find
    the same tensors at the same addresses step after step."""
    phases = [[a % (width * i) // i for a in col]
              for col, i in zip(ptrs, items)]
    heads = [min(size, -es[0] % width) if es.count(es[0]) == len(es)
             else size for size, *es in zip(sizes, *phases)]
    return (ctypes.c_longlong * len(heads))(*heads)


@functools.lru_cache(maxsize=1)
def _kernel():
    p, f, i = _checks.ptr, ctypes.c_float, ctypes.c_int
    return _build.function(
        "adam", "apex_adam",
        [p, p, p, p, p, p, p, i, i, i, i, p, p, p, f, f, f, f, f, f, f, f, f,
         i, i, p])


def launch_adam(noop, gs, ps, ms, vs, outs, *, lr, b1, b2, eps,
                weight_decay, adam_w, bc1=None, bc2=None, step=None,
                inv_scale=None, path=ADAM_STREAM):
    """The Adam kernel over the lists through its C function (``path``:
    :data:`ADAM_STREAM`, the first design or a planted fault's code);
    returns the launches made. :func:`adam` checks and counts; this does
    neither."""
    fn = _kernel()
    names = ("g", "p", "m", "v", "out")
    lists = dict(zip(names, (gs, ps, ms, vs, _none_list(outs, len(ps)))))
    bc1, bc2 = (1.0, 1.0) if step is not None else (bc1, bc2)
    launches = 0
    for (gd, pd, od), _, t, sizes, heads, n in _runs(lists,
                                                     ("g", "p", "out")):
        with torch.cuda.device(noop.device):
            rc = fn(*(t[name] for name in names), sizes, heads(), n, gd,
                    pd, od, noop.data_ptr(), _checks.data_ptr(step),
                    _checks.data_ptr(inv_scale), float(lr), float(bc1),
                    float(bc2), float(b1), 1.0 - b1, float(b2), 1.0 - b2,
                    float(eps), float(weight_decay), int(bool(adam_w)), path,
                    _checks.stream(noop))
        _checks.status("adam", rc)
        launches += 1
    return launches


def adam(noop, gs, ps, ms, vs, outs=None, *, lr, b1, b2, eps, weight_decay,
         adam_w, bc1=None, bc2=None, step=None, inv_scale=None):
    """Adam/AdamW over lists of grads (fp32 or bf16), the tensors they
    move (fp32 masters or parameters, or bf16 parameters without a
    master), exp_avgs and exp_avg_sqs (fp32): each g times ``inv_scale``
    (a one-element fp32 tensor, or None), ps, ms and vs updated in place,
    then each of ``outs`` (None, or a list whose entries are a parameter
    to write from its new master, or None) written in the same pass.
    Nothing changes where ``noop`` (a one-element fp32 tensor on their
    device) is > 0. The bias corrections are ``bc1`` and ``bc2`` (the
    step's values, rounded to fp32) or, where ``step`` is given, those of
    that one-element int32 tensor (the count after this update, read on
    the device: no host synchronisation). CPU tensors take
    :func:`adam_plain`; CUDA tensors launch the streaming kernel
    (:func:`adam_plan` per tensor), once per :data:`MAX_TENSORS` tensors
    of one dtype combination, or raise."""
    outs = _none_list(outs, len(ps))
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              adam_w=adam_w, bc1=bc1, bc2=bc2, step=step, inv_scale=inv_scale)
    extra = [t for t in (step, inv_scale, *outs) if t is not None]
    if not _checks.on_cuda("adam", noop, *extra, *gs, *ps, *ms, *vs):
        return adam_plain(noop, gs, ps, ms, vs, outs, **kw)
    _scalar("adam", noop, torch.float32, "noop")
    _scalar("adam", step, torch.int32, "step")
    _scalar("adam", inv_scale, torch.float32, "inv_scale")
    if step is None and (bc1 is None or bc2 is None):
        raise ValueError("adam: give the bias corrections bc1 and bc2, or a "
                         "device step")
    _check_lists("adam", dict(g=gs, p=ps, m=ms, v=vs, out=outs),
                 fp32=("m", "v"))
    for k, (p, out) in enumerate(zip(ps, outs)):
        if p.dtype != torch.float32 and out is not None:
            raise TypeError(f"adam: tensor {k}: a parameter written from a "
                            f"master needs an fp32 master, got {p.dtype}")
    registry.count_all(
        ADAM, launch_adam(noop, gs, ps, ms, vs, outs, **kw),
        flops=15.0 * sum(p.numel() for p in ps),
        bytes=registry.nbytes(gs, outs) + 2 * registry.nbytes(ps, ms, vs))


def fused_lamb_mvu_plain(g, p, m, v, *, bc1, bc2, b1, b2, beta3, eps,
                         weight_decay, adam_w):
    """LAMB's moments and raw update of fp32 tensors: returns ``(m_new,
    v_new, update)``, the body of ``apex_tpu``'s ``fused_lamb_mvu``
    oracle in its fp32 order (L2 decay folded into g when not
    ``adam_w``). ``bc1`` and ``bc2`` as in
    :func:`fused_adam_update_plain`."""
    if not adam_w and weight_decay != 0:
        g = g + weight_decay * p
    m_new = b1 * m + beta3 * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    update = (m_new / bc1) / (_sqrt(v_new / bc2) + eps)
    if adam_w and weight_decay != 0:
        update = update + weight_decay * p
    return m_new, v_new, update


def lamb_plain(noop, gs, ps, ms, vs, us=None, *, found_inf=None, clip, b1,
               b2, beta3, eps, weight_decay, adam_w, bc1=None, bc2=None,
               step=None, inv_scale=None):
    """LAMB stage 1 over the lists, tensor by tensor: each g (bf16 or
    fp32) times ``inv_scale``, divided by ``clip`` (one-element fp32
    tensors, or None), then :func:`fused_lamb_mvu_plain` against the fp32
    p; m and v written in place and the update into u (None: over g).
    Where ``noop`` or ``found_inf`` (None: 0) is > 0 nothing is
    written. ``weight_decay``: one number, or one a tensor."""
    if not ps:
        return
    bc1, bc2 = _corrections(noop.device, bc1, bc2, step, b1, b2)
    skip = _skip(noop, found_inf)
    for g, p, m, v, u, wd in zip(gs, ps, ms, vs, gs if us is None else us,
                                 _decays(weight_decay, len(ps))):
        g32 = _unscaled(g, inv_scale)
        if clip is not None:
            g32 = g32 / clip.reshape(())
        new = fused_lamb_mvu_plain(
            g32, p.float(), m.float(), v.float(), bc1=bc1, bc2=bc2, b1=b1,
            b2=b2, beta3=beta3, eps=eps, weight_decay=wd, adam_w=adam_w)
        for old, val in zip((m, v, u), new):
            _write(skip, old, val)


@functools.lru_cache(maxsize=1)
def _lamb_kernel():
    p, f, i = _checks.ptr, ctypes.c_float, ctypes.c_int
    return _build.function(
        "lamb", "apex_lamb_stage1",
        [p, p, p, p, p, p, i, i, p, p, p, p, p, f, f, f, f, f, f, f, f, i, i,
         p])


def launch_lamb(noop, gs, ps, ms, vs, us, *, found_inf=None, clip, b1, b2,
                beta3, eps, weight_decay, adam_w, bc1=None, bc2=None,
                step=None, inv_scale=None, fault=0):
    """LAMB's stage 1 over the lists through its C function (``us``: None
    writes the updates over the gradients; ``weight_decay``: one number,
    or one a tensor, each distinct value its own runs; ``fault``: 0, or a
    planted fault's code); returns the launches made. :func:`lamb` checks
    and counts; this does neither."""
    fn = _lamb_kernel()
    lists = dict(g=gs, p=ps, m=ms, v=vs, u=gs if us is None else us)
    bc1, bc2 = (1.0, 1.0) if step is not None else (bc1, bc2)
    wds = _decays(weight_decay, len(gs))
    launches = 0
    for wd in dict.fromkeys(wds):  # the distinct decays, in order
        index = [k for k, w in enumerate(wds) if w == wd]
        sub = {name: [col[k] for k in index] for name, col in lists.items()}
        for (gd,), _, t, sizes, _, n in _runs(sub, ("g",)):
            with torch.cuda.device(noop.device):
                rc = fn(t["g"], t["p"], t["m"], t["v"], t["u"], sizes, n, gd,
                        noop.data_ptr(), _checks.data_ptr(found_inf),
                        _checks.data_ptr(clip), _checks.data_ptr(step),
                        _checks.data_ptr(inv_scale), float(bc1), float(bc2),
                        float(b1), float(beta3), float(b2), 1.0 - b2,
                        float(eps), wd, int(bool(adam_w)), fault,
                        _checks.stream(noop))
            _checks.status("lamb", rc)
            launches += 1
    return launches


def _decays(weight_decay, n):
    """Each of ``n`` tensors' weight decay as a float: ``weight_decay`` a
    number for them all, or a sequence of one a tensor (JAX's
    ``per_tensor_decay``)."""
    if isinstance(weight_decay, (int, float)):
        return [float(weight_decay)] * n
    wds = [float(w) for w in weight_decay]
    if len(wds) != n:
        raise ValueError(f"{len(wds)} weight decays for {n} tensors")
    return wds


def lamb(noop, gs, ps, ms, vs, us=None, *, found_inf=None, clip, b1, b2,
         beta3, eps, weight_decay, adam_w, bc1=None, bc2=None, step=None,
         inv_scale=None):
    """LAMB stage 1 over lists of grads (fp32 or bf16), params or fp32
    masters, exp_avgs and exp_avg_sqs (fp32): each g times ``inv_scale``
    and divided by ``clip`` (the global gradient-clip factor; one-element
    fp32 tensors on their device, or None), exp_avgs and exp_avg_sqs
    updated in place and each tensor's raw update written into ``us``
    (fp32), or, where ``us`` is None, over the fp32 grads (the
    reference's stage 1 stores the update in the gradient). The bias
    corrections are ``bc1`` and ``bc2`` or those of the device ``step``
    (as :func:`adam`). ``weight_decay`` is one number, or one a tensor
    (JAX's ``per_tensor_decay``: the tensors of each distinct value go to
    launches of their own, the kernel taking one decay a launch). Nothing
    is written where ``noop`` or ``found_inf`` (None: 0) is > 0. No host
    synchronisation. CPU tensors take :func:`lamb_plain`; CUDA tensors
    launch the kernel, once per :data:`MAX_TENSORS` tensors of one
    gradient dtype and one decay, or raise."""
    kw = dict(found_inf=found_inf, clip=clip, b1=b1, b2=b2, beta3=beta3,
              eps=eps, weight_decay=weight_decay, adam_w=adam_w, bc1=bc1,
              bc2=bc2, step=step, inv_scale=inv_scale)
    extra = [t for t in (found_inf, clip, step, inv_scale, *(us or ()))
             if t is not None]
    if not _checks.on_cuda("lamb", noop, *extra, *gs, *ps, *ms, *vs):
        return lamb_plain(noop, gs, ps, ms, vs, us, **kw)
    for what, t, dtype in (("noop", noop, torch.float32),
                           ("found_inf", found_inf, torch.float32),
                           ("clip", clip, torch.float32),
                           ("step", step, torch.int32),
                           ("inv_scale", inv_scale, torch.float32)):
        _scalar("lamb", t, dtype, what)
    if step is None and (bc1 is None or bc2 is None):
        raise ValueError("lamb: give the bias corrections bc1 and bc2, or a "
                         "device step")
    lists = dict(g=gs, p=ps, m=ms, v=vs, u=gs if us is None else us)
    _check_lists("lamb", lists, fp32=("p", "m", "v", "u"))
    registry.count_all(
        LAMB, launch_lamb(noop, gs, ps, ms, vs, us, **kw),
        flops=15.0 * sum(p.numel() for p in ps),
        bytes=registry.nbytes(gs, ps, us or gs) + 2 * registry.nbytes(ms, vs))


def sgd_plain(noop, gs, ps, moms, outs=None, *, step, inv_scale=None, wd=0.0,
              momentum=0.0, dampening=0.0, lr, nesterov=False,
              wd_after_momentum=False):
    """JAX's ``multi_tensor_sgd`` in its fp32 order over the lists: p and
    the momentum buffers written in place, then each out (None: none)
    from the new p; ``first_run`` where the device ``step`` (the count
    before this update) is 0. Where ``noop`` is > 0 nothing changes."""
    if not ps:
        return
    skip = noop.reshape(()) > 0
    first_run = step.reshape(()) == 0
    device = noop.device
    f32 = functools.partial(torch.full, (), dtype=torch.float32,
                            device=device)
    wd_, mu, damp, lr_ = f32(wd), f32(momentum), f32(1.0 - dampening), f32(lr)
    for g, p, mom, out in zip(gs, ps, moms, _none_list(outs, len(ps))):
        g32 = _unscaled(g, inv_scale)
        if wd != 0 and not wd_after_momentum:
            g32 = g32 + wd_ * p
        if momentum != 0:
            m32 = torch.where(first_run, g32, mu * mom + damp * g32)
            d = g32 + mu * m32 if nesterov else m32
            _write(skip, mom, m32)
        else:
            d = g32
        if wd != 0 and wd_after_momentum:
            d = d + wd_ * p
        _write(skip, p, p - lr_ * d)
        if out is not None:
            _write(skip, out, p)


def lamb_stage2_plain(noop, found_inf, ps, us, outs, factors):
    """``p - factors[k] * u`` (the product rounded, then the difference)
    into each fp32 p, then each out (None: none) from the new p; where
    ``noop`` or ``found_inf`` is > 0 nothing changes. ``factors``: an fp32
    tensor [len(ps)] on their device."""
    if not ps:
        return
    skip = _skip(noop, found_inf)
    outs = _none_list(outs, len(ps))
    for p, u, out, f in zip(ps, us, outs, factors.unbind(0)):
        _write(skip, p, p - f * u)
        if out is not None:
            _write(skip, out, p)


def _skip(noop, found_inf):
    skip = noop.reshape(()) > 0
    return skip if found_inf is None else skip | (found_inf.reshape(()) > 0)


def _scalar(name, t, dtype, what):
    if t is not None and (t.dtype != dtype or t.numel() != 1):
        raise ValueError(f"{name}: {what} must be a one-element {dtype} "
                         f"tensor")


def _check_lists(name, lists, fp32):
    """Equal lengths; each tensor fp32 or bf16 (the lists named in
    ``fp32``: fp32 only), one shape, contiguous; None entries skipped."""
    if len({len(ts) for ts in lists.values()}) != 1:
        raise ValueError(f"{name}: lists of "
                         f"{ {k: len(ts) for k, ts in lists.items()} } tensors")
    for k, ts in enumerate(zip(*lists.values())):
        shape = None
        for what, t in zip(lists, ts):
            if t is None:
                continue
            if what in fp32 and t.dtype != torch.float32:
                raise TypeError(f"{name}: tensor {k}: {what} must be float32, "
                                f"got {t.dtype}")
            _checks.dtype_code(name, t, f"tensor {k}'s {what}")
            if shape is not None and t.shape != shape:
                raise ValueError(f"{name}: tensor {k}: shapes differ")
            shape = t.shape
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensor {k} must be contiguous")


def _runs(lists, keyed):
    """Launch tables over ``lists`` (a dict of equal-length lists whose
    entries may be None): the tensors grouped by the dtype codes of the
    lists named in ``keyed``, each group cut into runs of at most
    :data:`MAX_TENSORS` that hold an element. The first list has every
    entry; in a run, each other list is all tensors of one dtype (keyed,
    or checked by the caller) or all None. Yields (dtype codes, the run's
    indices, {name: pointer table}, sizes, heads, n): ``heads(width=4)``
    the run's scalar heads for a streaming body (:func:`_plan_heads` on
    the pointers the tables hold)."""
    names = list(lists)
    groups = {}
    for k, dtypes in enumerate(zip(*[
            [None if t is None else t.dtype for t in lists[name]]
            for name in keyed])):
        groups.setdefault(dtypes, []).append(k)
    for dtypes, index in groups.items():
        key = tuple(-1 if d is None else _checks.DTYPE_CODES[d]
                    for d in dtypes)
        for at in range(0, len(index), MAX_TENSORS):
            run = index[at:at + MAX_TENSORS]
            first = lists[names[0]]
            sizes = tuple([first[k].numel() for k in run])
            if not any(sizes):
                continue  # nothing to update: no launch
            n = len(run)
            tables, ptrs, items = {}, [], []
            for name in names:
                col = lists[name]
                if col[run[0]] is None:
                    tables[name] = (ctypes.c_void_p * n)()
                    continue
                ptr = tuple([col[k].data_ptr() for k in run])
                tables[name] = (ctypes.c_void_p * n)(*ptr)
                ptrs.append(ptr)
                items.append(col[run[0]].element_size())
            yield (key, run, tables, (ctypes.c_longlong * n)(*sizes),
                   functools.partial(_plan_heads, tuple(ptrs), tuple(items),
                                     sizes), n)


def _none_list(ts, n):
    return [None] * n if ts is None else list(ts)


@functools.lru_cache(maxsize=1)
def _sgd_kernel():
    p, f, i = _checks.ptr, ctypes.c_float, ctypes.c_int
    return _build.function(
        "sgd", "apex_sgd",
        [p, p, p, p, p, p, i, i, i, p, p, p, f, f, f, f, i, i, i, i, p])


def launch_sgd(noop, gs, ps, moms, outs, *, step, inv_scale, wd, momentum,
               dampening, lr, nesterov, wd_after_momentum, fault=0,
               path=SGD_STREAM):
    """The SGD kernel over the lists through its C function (``path``:
    :data:`SGD_STREAM` or the first design; ``fault``: 0, or a planted
    fault's code); returns the launches made. :func:`sgd` checks and
    counts; this does neither."""
    fn = _sgd_kernel()
    names = ("g", "p", "mom", "out")
    lists = dict(zip(names, (gs, ps, moms, _none_list(outs, len(ps)))))
    launches = 0
    for (gd, od), _, t, sizes, heads, n in _runs(lists, ("g", "out")):
        with torch.cuda.device(noop.device):
            rc = fn(t["g"], t["p"], t["mom"], t["out"], sizes, heads(), n,
                    gd, od, noop.data_ptr(), step.data_ptr(),
                    _checks.data_ptr(inv_scale), float(wd), float(momentum),
                    1.0 - dampening, float(lr), int(bool(nesterov)),
                    int(bool(wd_after_momentum)), fault, path,
                    _checks.stream(noop))
        _checks.status("sgd", rc)
        launches += 1
    return launches


def sgd(noop, gs, ps, moms, outs=None, *, step, inv_scale=None, wd=0.0,
        momentum=0.0, dampening=0.0, lr, nesterov=False,
        wd_after_momentum=False):
    """SGD with momentum (JAX's ``multi_tensor_sgd``): each g (fp32 or
    bf16) times ``inv_scale`` (a one-element fp32 tensor, or None), the
    fp32 p and momentum buffers updated in place, then each of ``outs``
    (None, or entries a parameter to write from the new p, or None).
    ``first_run`` where ``step`` (a one-element int32 tensor, the count
    before this update) is 0. Nothing changes where ``noop`` is > 0. No
    host synchronisation. CPU tensors take :func:`sgd_plain`; CUDA tensors
    launch the streaming kernel (:func:`adam_plan` per tensor), once per
    :data:`MAX_TENSORS` tensors of one dtype pair, or raise."""
    outs = _none_list(outs, len(ps))
    kw = dict(step=step, inv_scale=inv_scale, wd=wd, momentum=momentum,
              dampening=dampening, lr=lr, nesterov=nesterov,
              wd_after_momentum=wd_after_momentum)
    extra = [t for t in (step, inv_scale, *outs) if t is not None]
    if not _checks.on_cuda("sgd", noop, *extra, *gs, *ps, *moms):
        return sgd_plain(noop, gs, ps, moms, outs, **kw)
    _scalar("sgd", noop, torch.float32, "noop")
    _scalar("sgd", step, torch.int32, "step")
    _scalar("sgd", inv_scale, torch.float32, "inv_scale")
    _check_lists("sgd", dict(g=gs, p=ps, mom=moms, out=outs),
                 fp32=("p", "mom"))
    registry.count_all(
        SGD, launch_sgd(noop, gs, ps, moms, outs, **kw),
        flops=4.0 * sum(p.numel() for p in ps),
        bytes=registry.nbytes(gs, outs) + 2 * registry.nbytes(ps, moms))


@functools.lru_cache(maxsize=1)
def _lamb_stage2_kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function("lamb", "apex_lamb_stage2",
                           [p, p, p, p, p, i, i, p, p, i, p])


def launch_lamb_stage2(noop, found_inf, ps, us, outs, factors, fault=0):
    """LAMB's stage 2 over the lists through its C function (``fault``: 0,
    or a planted fault's code); returns the launches made.
    :func:`lamb_stage2` checks and counts; this does neither."""
    fn = _lamb_stage2_kernel()
    lists = dict(p=ps, u=us, out=outs)
    base, item = factors.data_ptr(), factors.element_size()
    launches = 0
    for (od,), run, t, sizes, _, n in _runs(lists, ("out",)):
        f = (ctypes.c_void_p * n)(*[base + item * k for k in run])
        with torch.cuda.device(noop.device):
            rc = fn(t["p"], t["u"], t["out"], f, sizes, n, od,
                    noop.data_ptr(), _checks.data_ptr(found_inf), fault,
                    _checks.stream(noop))
        _checks.status("lamb_stage2", rc)
        launches += 1
    return launches


def lamb_stage2(noop, found_inf, ps, us, outs, factors):
    """LAMB's parameter step: each fp32 p becomes ``p - factors[k] * u``
    (the product rounded, then the difference; ``factors`` an fp32 tensor
    [len(ps)], lr times each tensor's trust ratio), then each of ``outs``
    (None, or entries a parameter to write from the new p, or None).
    Nothing changes where ``noop`` or ``found_inf`` (None: 0) is > 0. No
    host synchronisation. CPU tensors take :func:`lamb_stage2_plain`;
    CUDA tensors launch the kernel, once per :data:`MAX_TENSORS` tensors
    of one output dtype, or raise."""
    outs = _none_list(outs, len(ps))
    extra = [t for t in (found_inf, *outs) if t is not None]
    if not _checks.on_cuda("lamb_stage2", noop, factors, *extra, *ps, *us):
        return lamb_stage2_plain(noop, found_inf, ps, us, outs, factors)
    _scalar("lamb_stage2", noop, torch.float32, "noop")
    _scalar("lamb_stage2", found_inf, torch.float32, "found_inf")
    if (factors.dtype != torch.float32 or factors.shape != (len(ps),)
            or not factors.is_contiguous()):
        raise ValueError(f"lamb_stage2: factors must be a contiguous float32 "
                         f"tensor [{len(ps)}]")
    _check_lists("lamb_stage2", dict(p=ps, u=us, out=outs), fp32=("p", "u"))
    registry.count_all(
        LAMB_STAGE2, launch_lamb_stage2(noop, found_inf, ps, us, outs,
                                        factors),
        flops=2.0 * sum(p.numel() for p in ps),
        bytes=2 * registry.nbytes(ps) + registry.nbytes(us, outs))


def _divided(g, scale):
    """g in fp32, divided by ``scale`` (a one-element fp32 tensor, or
    None) as JAX's ``g.astype(f32) / scale``."""
    g = g.float()
    return g if scale is None else g / scale.reshape(())


def adagrad_plain(noop, gs, ps, hs, outs=None, *, lr, eps, weight_decay,
                  mode, scale=None):
    """JAX's ``multi_tensor_adagrad`` in its fp32 order over the lists:
    each g divided by ``scale``, p and h written in place, then each out
    (None: none) from the new p. Where ``noop`` is > 0 nothing changes."""
    if not ps:
        return
    skip = noop.reshape(()) > 0
    f32 = functools.partial(torch.full, (), dtype=torch.float32,
                            device=noop.device)
    wd, lr_, eps_ = f32(weight_decay), f32(lr), f32(eps)
    for g, p, h, out in zip(gs, ps, hs, _none_list(outs, len(ps))):
        g32 = _divided(g, scale)
        if mode == 0 and weight_decay != 0:
            g32 = g32 + wd * p
        h32 = h + torch.square(g32)
        update = g32 / (_sqrt(h32) + eps_)
        if mode == 1 and weight_decay != 0:
            update = update + wd * p
        _write(skip, h, h32)
        _write(skip, p, p - lr_ * update)
        if out is not None:
            _write(skip, out, p)


@functools.lru_cache(maxsize=1)
def _adagrad_kernel():
    p, f, i = _checks.ptr, ctypes.c_float, ctypes.c_int
    return _build.function(
        "adagrad", "apex_adagrad",
        [p, p, p, p, p, p, i, i, i, p, p, f, f, f, i, i, p])


def launch_adagrad(noop, gs, ps, hs, outs, *, lr, eps, weight_decay, mode,
                   scale=None, fault=0):
    """The Adagrad kernel over the lists through its C function
    (``fault``: 0, or a planted fault's code); returns the launches made.
    :func:`adagrad` checks and counts; this does neither."""
    fn = _adagrad_kernel()
    names = ("g", "p", "h", "out")
    lists = dict(zip(names, (gs, ps, hs, _none_list(outs, len(ps)))))
    launches = 0
    for (gd, od), _, t, sizes, heads, n in _runs(lists, ("g", "out")):
        with torch.cuda.device(noop.device):
            rc = fn(t["g"], t["p"], t["h"], t["out"], sizes, heads(), n, gd,
                    od, noop.data_ptr(), _checks.data_ptr(scale), float(lr),
                    float(eps), float(weight_decay), int(mode), fault,
                    _checks.stream(noop))
        _checks.status("adagrad", rc)
        launches += 1
    return launches


def adagrad(noop, gs, ps, hs, outs=None, *, lr, eps, weight_decay, mode,
            scale=None):
    """Adagrad (JAX's ``multi_tensor_adagrad``; ``mode`` 0: L2 decay into
    the gradient, 1: decoupled, ``adagrad_w_mode``): each g (fp32 or
    bf16) divided by ``scale`` (a one-element fp32 tensor, or None: no
    division), the fp32 p and sums h updated in place, then each of
    ``outs`` (None, or entries a parameter to write from the new p, or
    None). Nothing changes where ``noop`` is > 0. No host
    synchronisation. CPU tensors take :func:`adagrad_plain`; CUDA tensors
    launch the streaming kernel (:func:`adam_plan` per tensor), once per
    :data:`MAX_TENSORS` tensors of one dtype pair, or raise."""
    if mode not in (0, 1):
        raise ValueError(f"adagrad: mode must be 0 or 1, got {mode}")
    outs = _none_list(outs, len(ps))
    kw = dict(lr=lr, eps=eps, weight_decay=weight_decay, mode=mode,
              scale=scale)
    extra = [t for t in (scale, *outs) if t is not None]
    if not _checks.on_cuda("adagrad", noop, *extra, *gs, *ps, *hs):
        return adagrad_plain(noop, gs, ps, hs, outs, **kw)
    _scalar("adagrad", noop, torch.float32, "noop")
    _scalar("adagrad", scale, torch.float32, "scale")
    _check_lists("adagrad", dict(g=gs, p=ps, h=hs, out=outs),
                 fp32=("p", "h"))
    registry.count_all(
        ADAGRAD, launch_adagrad(noop, gs, ps, hs, outs, **kw),
        flops=6.0 * sum(p.numel() for p in ps),
        bytes=registry.nbytes(gs, outs) + 2 * registry.nbytes(ps, hs))


def novograd_norms_plain(gs, *, norm_type, scale=None):
    """Each tensor's squared gradient norm as NovoGrad takes it (JAX's
    ``gnorm_sq``): ``sum(g * g)`` for ``norm_type`` 2, ``max(|g|)^2``
    otherwise, of g divided by ``scale``; an fp32 tensor [len(gs)]. The
    sums are torch's, in another order than the kernel's or XLA's."""
    out = []
    for g in gs:
        g32 = _divided(g, scale)
        if norm_type == 2:
            out.append(torch.square(g32).sum())
        elif g32.numel():
            out.append(torch.square(g32.abs().amax()))
        else:
            out.append(g32.new_zeros(()))
    return torch.stack(out) if out else torch.zeros(0)


def novograd_plain(noop, gs, ps, ms, v, outs=None, *, slots=None, step, lr,
                   b1, b2, beta3, eps, weight_decay, moment_mode, norm_type,
                   init_zero, bias_correction, scale=None, v_given=None):
    """JAX's ``multi_tensor_novograd`` in its fp32 order over the lists:
    each g divided by ``scale``; tensor k's second moment ``v[slots[k]]``
    (``slots`` None: k) from its norm (:func:`novograd_norms_plain`), its
    first value where the device ``step`` (the count after this update)
    is 1; then p and m in place and each out (None: none) from the new p.
    ``v_given`` (an fp32 tensor [len(gs)], or None) takes the place of the
    new second moments, to hold the elementwise pass alone against a
    kernel's. Where ``noop`` is > 0 nothing changes, v included."""
    if not ps:
        return
    slots = list(range(len(ps))) if slots is None else list(slots)
    device = noop.device
    skip = noop.reshape(()) > 0
    step = step.reshape(())
    f32 = functools.partial(torch.full, (), dtype=torch.float32,
                            device=device)
    b1_, b2_, omb2, beta3_ = f32(b1), f32(b2), f32(1.0 - b2), f32(beta3)
    wd, lr_, eps_ = f32(weight_decay), f32(lr), f32(eps)
    bc1 = (device_bias_corrections(b1, b2, step)[0] if bias_correction
           else f32(1.0))
    if v_given is None:
        norms = novograd_norms_plain(gs, norm_type=norm_type, scale=scale)
        norms = norms.to(device)
        v_prev = v[slots]
        first = omb2 * norms if init_zero else norms
        v_new = torch.where(step == 1, first, b2_ * v_prev + omb2 * norms)
    else:
        v_new = v_given.to(device)
    for k, (g, p, m, out) in enumerate(zip(gs, ps, ms,
                                           _none_list(outs, len(ps)))):
        g32 = _divided(g, scale)
        gn = g32 / (_sqrt(v_new[k]) + eps_)
        if moment_mode == 0 and weight_decay != 0:
            gn = gn + wd * p
        m32 = b1_ * m + beta3_ * gn
        update = m32 / bc1
        if moment_mode == 1 and weight_decay != 0:
            update = update + wd * p
        _write(skip, m, m32)
        _write(skip, p, p - lr_ * update)
        if out is not None:
            _write(skip, out, p)
    for k, slot in enumerate(slots):
        _write(skip, v[slot], v_new[k])


@functools.lru_cache(maxsize=1)
def _novograd_kernel():
    p, f, i = _checks.ptr, ctypes.c_float, ctypes.c_int
    return _build.function(
        "novograd", "apex_novograd",
        [p, p, p, p, p, p, p, i, i, i, p, p, p, p, ctypes.c_longlong, f, f,
         f, f, f, f, f, i, i, i, i, i, p])


def novograd_scratch(sizes):
    """Floats of novograd.cu's scratch for a launch over tensors of
    ``sizes`` elements: a partial for each chunk (at most
    ceil(size / :data:`STREAM_CHUNK`) a tensor, whatever its head) and
    the blocks' count."""
    return sum(-(-n // STREAM_CHUNK) for n in sizes) + 1


def launch_novograd(noop, gs, ps, ms, v, outs, *, slots=None, step, lr, b1,
                    b2, beta3, eps, weight_decay, moment_mode, norm_type,
                    init_zero, bias_correction, scale=None, fault=0):
    """The NovoGrad kernel over the lists through its C function (its two
    CUDA kernels, the norms and the update; ``fault``: 0, or a planted
    fault's code); returns the launches made. :func:`novograd` checks and
    counts; this does neither."""
    fn = _novograd_kernel()
    slots = list(range(len(ps))) if slots is None else list(slots)
    names = ("g", "p", "m", "out")
    lists = dict(zip(names, (gs, ps, ms, _none_list(outs, len(ps)))))
    base, item = v.data_ptr(), v.element_size()
    launches = 0
    for (gd, od), run, t, sizes, heads, n in _runs(lists, ("g", "out")):
        vs = (ctypes.c_void_p * n)(*[base + item * slots[k] for k in run])
        scratch = torch.zeros(novograd_scratch(sizes), dtype=torch.float32,
                              device=noop.device)
        with torch.cuda.device(noop.device):
            rc = fn(t["g"], t["p"], t["m"], t["out"], vs, sizes, heads(), n,
                    gd, od, noop.data_ptr(), step.data_ptr(),
                    _checks.data_ptr(scale), scratch.data_ptr(),
                    scratch.numel(), float(lr), float(b1), float(beta3),
                    float(b2), 1.0 - b2, float(eps), float(weight_decay),
                    int(moment_mode), 2 if norm_type == 2 else 0,
                    int(bool(init_zero)), int(bool(bias_correction)), fault,
                    _checks.stream(noop))
        _checks.status("novograd", rc)
        launches += 1
    return launches


def novograd(noop, gs, ps, ms, v, outs=None, *, slots=None, step, lr, b1, b2,
             beta3, eps, weight_decay, moment_mode, norm_type, init_zero,
             bias_correction, scale=None):
    """NovoGrad (JAX's ``multi_tensor_novograd``): each g (fp32 or bf16)
    divided by ``scale`` (a one-element fp32 tensor, or None); tensor k's
    second moment ``v[slots[k]]`` (``v`` an fp32 tensor of one value a
    tensor, ``slots`` None: k) from its squared gradient norm (L2 for
    ``norm_type`` 2, else the max norm), taking its first value
    (``init_zero``: ``(1 - b2) * norm``, else the norm) where ``step`` (a
    one-element int32 tensor, the count after this update) is 1; then
    the fp32 p and exp_avgs m updated in place (``moment_mode`` 0: L2
    decay into the normalised gradient, 1: decoupled; bc1 from ``step``
    with ``bias_correction``) and each of ``outs`` (None, or entries a
    parameter to write from the new p, or None). Nothing changes where
    ``noop`` is > 0, v included. No host synchronisation. CPU tensors
    take :func:`novograd_plain`; CUDA tensors launch the kernel (two
    CUDA kernels: the norms, summed in a fixed order, and the update),
    once per :data:`MAX_TENSORS` tensors of one dtype pair, or raise."""
    if moment_mode not in (0, 1):
        raise ValueError(f"novograd: moment_mode must be 0 or 1, got "
                         f"{moment_mode}")
    outs = _none_list(outs, len(ps))
    slots = list(range(len(ps))) if slots is None else list(slots)
    kw = dict(slots=slots, step=step, lr=lr, b1=b1, b2=b2, beta3=beta3,
              eps=eps, weight_decay=weight_decay, moment_mode=moment_mode,
              norm_type=norm_type, init_zero=init_zero,
              bias_correction=bias_correction, scale=scale)
    extra = [t for t in (scale, *outs) if t is not None]
    if not _checks.on_cuda("novograd", noop, step, v, *extra, *gs, *ps, *ms):
        return novograd_plain(noop, gs, ps, ms, v, outs, **kw)
    _scalar("novograd", noop, torch.float32, "noop")
    _scalar("novograd", step, torch.int32, "step")
    _scalar("novograd", scale, torch.float32, "scale")
    if v.dtype != torch.float32 or v.dim() != 1 or not v.is_contiguous():
        raise ValueError("novograd: v must be a contiguous float32 vector")
    if len(slots) != len(ps) or any(not 0 <= s < v.numel() for s in slots):
        raise ValueError(f"novograd: slots {slots} do not index v's "
                         f"{v.numel()} values, one a tensor")
    _check_lists("novograd", dict(g=gs, p=ps, m=ms, out=outs),
                 fp32=("p", "m"))
    registry.count_all(
        NOVOGRAD, launch_novograd(noop, gs, ps, ms, v, outs, **kw),
        flops=10.0 * sum(p.numel() for p in ps),
        bytes=2 * registry.nbytes(gs) + registry.nbytes(outs)
        + 2 * registry.nbytes(ps, ms))
