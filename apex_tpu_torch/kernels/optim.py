"""Multi-tensor Adam/AdamW update and LAMB stage 1: the CUDA kernels
(csrc/adam.cu, csrc/lamb.cu) and their plain PyTorch versions.

Counterparts of ``apex_tpu/kernels/optim.py`` ``fused_adam_update`` and
``fused_lamb_mvu``, which update one flat fp32 buffer per call. Here one
launch updates a list of up to :data:`MAX_TENSORS` fp32 tensors in
place, as the reference's ``multi_tensor_apply`` does, and :func:`adam`
and :func:`lamb` make as many launches as the list needs. The entry
points are :func:`apex_tpu_torch.ops.multi_tensor.multi_tensor_adam` and
``multi_tensor_lamb``.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

MAX_TENSORS = 64  # tensors in one launch's table (kMaxTensors in the .cu)
# path codes of apex_adam (csrc/adam.cu): the first design, the streaming
# body that the wrapper launches
ADAM_FIRST, ADAM_STREAM = 0, 1
ADAM = registry.register("adam")
LAMB = registry.register("lamb")


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


def adam_plain(noop, gs, ps, ms, vs, *, lr, bc1, bc2, b1, b2, eps,
               weight_decay, adam_w):
    """:func:`fused_adam_update_plain` over the lists, tensor by tensor,
    written into ps, ms and vs in place; where ``noop`` (a one-element
    fp32 tensor) is non-zero every tensor keeps its old value."""
    if not ps:
        return
    device = ps[0].device
    # filled on the device (no host copy, so a CUDA graph can capture it)
    bc1 = torch.full((), bc1, dtype=torch.float32, device=device)
    bc2 = torch.full((), bc2, dtype=torch.float32, device=device)
    skip = noop.reshape(()) > 0
    for g, p, m, v in zip(gs, ps, ms, vs):
        new = fused_adam_update_plain(
            g.float(), p.float(), m.float(), v.float(), lr=lr, bc1=bc1,
            bc2=bc2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            adam_w=adam_w)
        for old, val in zip((p, m, v), new):
            old.copy_(torch.where(skip, old, val.to(old.dtype)))


class AdamSpan(NamedTuple):
    """How the streaming body covers one tensor: ``head`` elements one
    at a time, then ``vectors`` float4 of each of g, p, m and v (16-byte
    accesses), then ``tail`` elements one at a time."""
    head: int
    vectors: int
    tail: int


def adam_plan(size: int, offsets) -> AdamSpan:
    """The streaming body's cover of a tensor of ``size`` fp32 elements
    whose g, p, m and v start ``offsets`` (each ``data_ptr() % 16``)
    bytes past a 16-byte boundary: where the four offsets agree, the
    scalar head runs up to the first element on the boundary and the
    vectors to the last whole float4, the tail takes the rest (size % 4
    past the head); otherwise every element is head (no 16-byte access
    can serve all four arrays at once)."""
    if len(set(offsets)) != 1 or offsets[0] % 4:
        return AdamSpan(size, 0, 0)
    head = min(size, (16 - offsets[0]) % 16 // 4)
    vectors = (size - head) // 4
    return AdamSpan(head, vectors, size - head - 4 * vectors)


@functools.lru_cache(maxsize=1)
def _kernel():
    p, f, i = _checks.ptr, ctypes.c_float, ctypes.c_int
    return _build.function(
        "adam", "apex_adam",
        [p, p, p, p, p, p, i, p, f, f, f, f, f, f, f, f, f, i, i, p])


def _check(name, noop, gs, ps, ms, vs):
    if not len(gs) == len(ps) == len(ms) == len(vs):
        raise ValueError(f"{name}: lists of {len(gs)} grads, {len(ps)} "
                         f"params, {len(ms)} exp_avgs and {len(vs)} "
                         f"exp_avg_sqs")
    if noop.dtype != torch.float32 or noop.numel() != 1:
        raise ValueError(f"{name}: noop must be a one-element float32 "
                         f"tensor")
    for k, ts in enumerate(zip(gs, ps, ms, vs)):
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError(f"{name}: tensor {k}: grad, param, exp_avg and "
                            f"exp_avg_sq must be float32, got "
                            f"{[str(t.dtype) for t in ts]}")
        if any(t.shape != ts[1].shape for t in ts):
            raise ValueError(f"{name}: tensor {k}: shapes differ: "
                             f"{[tuple(t.shape) for t in ts]}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError(f"{name}: tensor {k} must be contiguous")


def _tables(lists):
    """For each run of at most :data:`MAX_TENSORS` tensors that holds an
    element: the run (each list's slice), the pointer table of each list,
    the sizes and the count."""
    for a in range(0, len(lists[1]), MAX_TENSORS):
        run = [ts[a:a + MAX_TENSORS] for ts in lists]
        n = len(run[1])
        if not any(t.numel() for t in run[1]):
            continue  # nothing to update: no launch
        tables = [(ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])
                  for ts in run]
        sizes = (ctypes.c_longlong * n)(*[t.numel() for t in run[1]])
        yield run, tables, sizes, n


def _heads(run):
    """Each tensor's scalar head (:func:`adam_plan`) for a run of g, p,
    m and v lists, as apex_adam reads them."""
    return (ctypes.c_longlong * len(run[1]))(*[
        adam_plan(ts[1].numel(), [t.data_ptr() % 16 for t in ts]).head
        for ts in zip(*run)])


def adam(noop, gs, ps, ms, vs, *, lr, bc1, bc2, b1, b2, eps, weight_decay,
         adam_w):
    """Adam/AdamW over lists of fp32 grads, params, exp_avgs and
    exp_avg_sqs, updating ps, ms and vs in place unless ``noop`` (a
    one-element fp32 tensor on their device) is non-zero. ``lr``,
    ``bc1`` and ``bc2`` are the step's values (rounded to fp32). CPU
    tensors take :func:`adam_plain`; CUDA tensors launch the streaming
    kernel (:func:`adam_plan` per tensor), once per :data:`MAX_TENSORS`
    tensors, or raise."""
    kw = dict(lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, adam_w=adam_w)
    if not _checks.on_cuda("adam", noop, *gs, *ps, *ms, *vs):
        return adam_plain(noop, gs, ps, ms, vs, **kw)
    _check("adam", noop, gs, ps, ms, vs)
    fn = _kernel()
    for run, tables, sizes, n in _tables((gs, ps, ms, vs)):
        with torch.cuda.device(noop.device):
            rc = fn(*tables, sizes, _heads(run), n, noop.data_ptr(),
                    float(lr), float(bc1), float(bc2), float(b1), 1.0 - b1,
                    float(b2), 1.0 - b2, float(eps), float(weight_decay),
                    int(bool(adam_w)), ADAM_STREAM, _checks.stream(noop))
        _checks.status("adam", rc)
        registry.count(ADAM)


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


def lamb_plain(noop, gs, ps, ms, vs, *, clip, bc1, bc2, b1, b2, beta3, eps,
               weight_decay, adam_w):
    """LAMB stage 1 over the lists, tensor by tensor: each g divided by
    ``clip`` (a one-element fp32 tensor, or None), then
    :func:`fused_lamb_mvu_plain`; m and v are written in place and the
    update over g. Where ``noop`` is non-zero nothing changes."""
    if not ps:
        return
    device = ps[0].device
    bc1 = torch.full((), bc1, dtype=torch.float32, device=device)
    bc2 = torch.full((), bc2, dtype=torch.float32, device=device)
    skip = noop.reshape(()) > 0
    for g, p, m, v in zip(gs, ps, ms, vs):
        gc = g.float() if clip is None else g.float() / clip.reshape(())
        new = fused_lamb_mvu_plain(
            gc, p.float(), m.float(), v.float(), bc1=bc1, bc2=bc2, b1=b1,
            b2=b2, beta3=beta3, eps=eps, weight_decay=weight_decay,
            adam_w=adam_w)
        for old, val in zip((m, v, g), new):
            old.copy_(torch.where(skip, old, val.to(old.dtype)))


@functools.lru_cache(maxsize=1)
def _lamb_kernel():
    p, f = _checks.ptr, ctypes.c_float
    return _build.function(
        "lamb", "apex_lamb_stage1",
        [p, p, p, p, p, ctypes.c_int, p, p, f, f, f, f, f, f, f, f,
         ctypes.c_int, p])


def lamb(noop, gs, ps, ms, vs, *, clip, bc1, bc2, b1, b2, beta3, eps,
         weight_decay, adam_w):
    """LAMB stage 1 over lists of fp32 grads, params, exp_avgs and
    exp_avg_sqs: exp_avgs and exp_avg_sqs updated in place and each
    grad overwritten by its tensor's raw update (the reference's stage 1
    stores the update in the gradient), unless ``noop`` (a one-element
    fp32 tensor on their device) is non-zero. ``clip`` is the global
    gradient-clip factor as a one-element fp32 tensor on that device (no
    host synchronisation), or None. CPU tensors take :func:`lamb_plain`;
    CUDA tensors launch the kernel, once per :data:`MAX_TENSORS` tensors,
    or raise."""
    kw = dict(clip=clip, bc1=bc1, bc2=bc2, b1=b1, b2=b2, beta3=beta3,
              eps=eps, weight_decay=weight_decay, adam_w=adam_w)
    extra = () if clip is None else (clip,)
    if not _checks.on_cuda("lamb", noop, *extra, *gs, *ps, *ms, *vs):
        return lamb_plain(noop, gs, ps, ms, vs, **kw)
    _check("lamb", noop, gs, ps, ms, vs)
    if clip is not None and (clip.dtype != torch.float32
                             or clip.numel() != 1):
        raise ValueError("lamb: clip must be a one-element float32 tensor")
    fn = _lamb_kernel()
    for _, tables, sizes, n in _tables((gs, ps, ms, vs)):
        with torch.cuda.device(noop.device):
            rc = fn(*tables, sizes, n, noop.data_ptr(),
                    None if clip is None else clip.data_ptr(), float(bc1),
                    float(bc2), float(b1), float(beta3), float(b2), 1.0 - b2,
                    float(eps), float(weight_decay), int(bool(adam_w)),
                    _checks.stream(noop))
        _checks.status("lamb", rc)
        registry.count(LAMB)
