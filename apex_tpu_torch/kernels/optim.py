"""Multi-tensor Adam/AdamW update: the CUDA kernel (csrc/adam.cu) and its
plain PyTorch version.

Counterpart of ``apex_tpu/kernels/optim.py`` ``fused_adam_update``,
which updates one flat fp32 buffer per call. Here one launch updates a
list of up to :data:`MAX_TENSORS` fp32 tensors in place, as the
reference's ``multi_tensor_apply`` does, and :func:`adam` makes as many
launches as the list needs. The entry point is
:func:`apex_tpu_torch.ops.multi_tensor.multi_tensor_adam`. The LAMB
kernel of that module comes with the BERT slice.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

MAX_TENSORS = 64  # tensors in one launch's table (kMaxTensors in adam.cu)
ADAM = registry.register("adam")


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
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
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


@functools.lru_cache(maxsize=1)
def _kernel():
    p, f = _checks.ptr, ctypes.c_float
    return _build.function(
        "adam", "apex_adam",
        [p, p, p, p, p, ctypes.c_int, p, f, f, f, f, f, f, f, f, f,
         ctypes.c_int, p])


def _check(noop, gs, ps, ms, vs):
    if not len(gs) == len(ps) == len(ms) == len(vs):
        raise ValueError(f"adam: lists of {len(gs)} grads, {len(ps)} params, "
                         f"{len(ms)} exp_avgs and {len(vs)} exp_avg_sqs")
    if noop.dtype != torch.float32 or noop.numel() != 1:
        raise ValueError("adam: noop must be a one-element float32 tensor")
    for k, ts in enumerate(zip(gs, ps, ms, vs)):
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError(f"adam: tensor {k}: grad, param, exp_avg and "
                            f"exp_avg_sq must be float32, got "
                            f"{[str(t.dtype) for t in ts]}")
        if any(t.shape != ts[1].shape for t in ts):
            raise ValueError(f"adam: tensor {k}: shapes differ: "
                             f"{[tuple(t.shape) for t in ts]}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError(f"adam: tensor {k} must be contiguous")


def adam(noop, gs, ps, ms, vs, *, lr, bc1, bc2, b1, b2, eps, weight_decay,
         adam_w):
    """Adam/AdamW over lists of fp32 grads, params, exp_avgs and
    exp_avg_sqs, updating ps, ms and vs in place unless ``noop`` (a
    one-element fp32 tensor on their device) is non-zero. ``lr``,
    ``bc1`` and ``bc2`` are the step's values (rounded to fp32). CPU
    tensors take :func:`adam_plain`; CUDA tensors launch the kernel,
    once per :data:`MAX_TENSORS` tensors, or raise."""
    kw = dict(lr=lr, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, adam_w=adam_w)
    if not _checks.on_cuda("adam", noop, *gs, *ps, *ms, *vs):
        return adam_plain(noop, gs, ps, ms, vs, **kw)
    _check(noop, gs, ps, ms, vs)
    fn = _kernel()
    for a in range(0, len(ps), MAX_TENSORS):
        b = min(a + MAX_TENSORS, len(ps))
        n = b - a
        if not any(t.numel() for t in ps[a:b]):
            continue  # nothing to update: no launch
        tables = [(ctypes.c_void_p * n)(*[t.data_ptr() for t in ts[a:b]])
                  for ts in (gs, ps, ms, vs)]
        sizes = (ctypes.c_longlong * n)(*[t.numel() for t in ps[a:b]])
        with torch.cuda.device(noop.device):
            rc = fn(*tables, sizes, n, noop.data_ptr(), float(lr), float(bc1),
                    float(bc2), float(b1), 1.0 - b1, float(b2), 1.0 - b2,
                    float(eps), float(weight_decay), int(bool(adam_w)),
                    _checks.stream(noop))
        _checks.status("adam", rc)
        registry.count(ADAM)
