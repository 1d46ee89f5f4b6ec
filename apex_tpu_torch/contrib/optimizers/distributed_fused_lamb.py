"""DistributedFusedLAMB: ZeRO-sharded LAMB over the data-parallel axis.

Counterpart of ``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``
(reference apex/contrib/optimizers/distributed_fused_lamb.py): the
layout, collectives, state and elastic forms of
:class:`~apex_tpu_torch.contrib.optimizers.DistributedFusedAdam`, with
LAMB's update:

1. the global gradient norm over the shard (summed over ranks) gives the
   clip factor ``max(norm / max_grad_norm, 1)``, which rides in #13's
   ``clip`` argument (the kernel divides g by it in fp32, where JAX
   divides right before its kernel);
2. one launch of the LAMB kernel (#13, ``kernels/optim.py`` ``lamb``)
   writes m, v and the raw update (over the gradient buffer);
3. each tensor's trust ratio ``||p|| / ||update||`` from its part of the
   shard: contiguous views summed with ``torch._foreach_norm`` (a fixed
   order, no atomics), the partial squares summed over ranks where a
   tensor straddles shards (JAX's ``segment_sum`` and ``psum``); the pad
   tail keeps ratio 1;
4. ``p -= lr * ratio * update`` per tensor, then the gather.

World 1 skips the collectives, as JAX's does; ``found_inf``, ``scale``
and the CPU step counter are as in ``DistributedFusedAdam``.
"""

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    _Zero,
    _flat_size,
    _flatten_f32,
    _next_step,
    _noop,
    _step_tensor,
    _unflatten_like,
)
from apex_tpu_torch.kernels import optim as _koptim
from apex_tpu_torch.ops.multi_tensor import bias_corrections
from apex_tpu_torch.parallel import compression, groups
from apex_tpu_torch.parallel.distributed import _div, _leaves, _rebuild

_NORM_CHUNK = 1 << 16  # elements a partial sum of the global norm


def _local_segments(sizes, padded, world, rank):
    """``(tensor index, start, stop)`` of each tensor's part of rank
    ``rank``'s shard of the padded flat vector, shard-relative; the pad
    tail is tensor ``len(sizes)``."""
    per = padded // world
    lo, hi = rank * per, (rank + 1) * per
    out, off = [], 0
    for i, size in enumerate(list(sizes) + [padded - sum(sizes)]):
        a, b = max(off, lo), min(off + size, hi)
        if a < b:
            out.append((i, a - lo, b - lo))
        off += size
    return out


class DistributedFusedLAMB(_Zero):
    """ZeRO LAMB with the reference's core arguments: decoupled
    (``adam_w_mode``) or L2 decay, gradient averaging (beta3 = 1 -
    beta1), the global clip at ``max_grad_norm`` (0: none) after the
    reduction, and, with ``use_nvlamb``, the trust ratio also where
    ``weight_decay`` is 0."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, max_grad_norm=1.0,
                 adam_w_mode=True, grad_averaging=True, use_nvlamb=False,
                 clip_after_ar=True, axis_name="dp", compress: bool = False,
                 grad_compress=None, param_compress=None,
                 compress_block_size: int = compression.BLOCK_SIZE,
                 numerics=None, overlap: bool = False,
                 message_size: int = 10000000):
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.use_nvlamb = use_nvlamb
        self.clip_after_ar = clip_after_ar
        self._setup(axis_name, compress, grad_compress, param_compress,
                    compress_block_size, numerics, overlap, message_size)

    @property
    def overlap_needs_global_norm(self):
        """True when clipping couples every bucket's update to the global
        gradient norm (one scalar join; the scatters stay independent)."""
        return bool(self.max_grad_norm and self.max_grad_norm > 0)

    def _average(self, g_shard, world):
        if world == 1 or not self.grad_averaging:
            return g_shard
        return _div(g_shard, world)

    def _sum_over_ranks(self, t, world):
        if world > 1:
            dist.all_reduce(t, group=groups.axis_group(self.axis_name))
        return t

    def overlap_global_clip(self, g_shards):
        """The clip factor (a one-element fp32 tensor) from the global
        gradient norm: the shards' sums of squares, summed over ranks;
        None without clipping."""
        if not self.overlap_needs_global_norm:
            return None
        # in chunks: a short sum each, as pairwise as XLA's (the CPU's
        # norm of one long vector accumulates in order)
        norms = torch._foreach_norm([c for g in g_shards
                                     for c in g.split(_NORM_CHUNK)])
        gsq = self._sum_over_ranks(torch.stack(norms).square().sum(),
                                   self._world())
        gnorm = torch.sqrt(gsq)
        return torch.clamp(_div(gnorm, self.max_grad_norm), min=1.0).reshape(1)

    def _per_tensor_sq(self, x, segs, T, world):
        """Each tensor's sum of squares over its parts of the shard,
        summed over ranks: [T + 1] fp32, the pad tail last."""
        idx = torch.tensor([i for i, _, _ in segs], device=x.device)
        norms = torch._foreach_norm([x[a:b] for _, a, b in segs])
        partial = torch.zeros(T + 1, dtype=torch.float32, device=x.device)
        partial.index_copy_(0, idx, torch.stack(norms).square())
        return self._sum_over_ranks(partial, world)

    def _update(self, noop, skip, g_shard, st, sizes, padded, step, lr,
                clip):
        """LAMB on one local shard, in place: #13 (m, v, the update over
        g_shard), the per-tensor trust ratios, ``p -= lr * ratio *
        update``."""
        world = self._world()
        b1, b2 = self.betas
        bc1, bc2 = (bias_corrections(b1, b2, step) if self.bias_correction
                    else (1.0, 1.0))
        p = st["master_shard"]
        _koptim.lamb(noop, [g_shard], [p], [st["exp_avg_shard"]],
                     [st["exp_avg_sq_shard"]], clip=clip, bc1=bc1, bc2=bc2,
                     b1=b1, b2=b2,
                     beta3=(1 - b1) if self.grad_averaging else 1.0,
                     eps=self.eps, weight_decay=self.weight_decay,
                     adam_w=bool(self.adam_w_mode))
        if skip:
            return
        T = len(sizes)
        segs = _local_segments(sizes, padded, world,
                               groups.axis_rank(self.axis_name))
        ratio = torch.ones(T + 1, dtype=torch.float32, device=p.device)
        if self.weight_decay != 0 or self.use_nvlamb:
            # p's norms before the update, as JAX takes them
            w_norm = torch.sqrt(self._per_tensor_sq(p, segs, T, world))
            u_norm = torch.sqrt(self._per_tensor_sq(g_shard, segs, T, world))
            ratio[:T] = torch.where((w_norm[:T] > 0) & (u_norm[:T] > 0),
                                    w_norm[:T] / u_norm[:T], 1.0)
        factors = (ratio * (self.lr if lr is None else lr)).unbind(0)
        steps = torch._foreach_mul([g_shard[a:b] for _, a, b in segs],
                                   [factors[i] for i, _, _ in segs])
        torch._foreach_sub_([p[a:b] for _, a, b in segs], steps)

    def bucket_update_gather(self, g_shard, bstate, bucket, p_leaves, *,
                             lr=None, step, noop, skip=False, clip=None,
                             new_residual=None):
        """The sharded LAMB update (one #13 launch; trust ratios from this
        bucket's own tensors) and the param gather for ONE bucket: (new
        param leaves, new bucket state). ``clip`` is the global factor of
        :meth:`overlap_global_clip` (None: no clipping)."""
        self._update(noop, skip, g_shard, bstate,
                     [leaf.numel() for leaf in p_leaves], bucket.padded,
                     step, lr, clip)
        flat_p = self._gather_params(bstate["master_shard"], self._world())
        new = self._finish(bstate, dict(bstate), new_residual, skip)
        return _unflatten_like(flat_p[:bucket.n], p_leaves), new

    def step(self, grads, state, params, *, lr: Optional[float] = None,
             found_inf=None, scale: float = 1.0):
        """One update: ``(new_params, new_state)``, plus the statistics
        of the local gradients with ``numerics=``; the state's shards are
        updated in place."""
        if self.overlap:
            return self._step_overlapped(grads, state, params, lr=lr,
                                         found_inf=found_inf, scale=scale)
        stats = self._grad_stats(grads)
        leaves, g_leaves = _leaves(params), _leaves(grads)
        n, world = _flat_size(params), self._world()
        padded = self._padded(n, world)
        noop, skip = _noop(found_inf, state["master_shard"].device)
        flat_g = _flatten_f32(g_leaves, padded, scale)
        g_shard, residual = self._reduce_scatter(
            flat_g, state.get("grad_residual"), world)
        g_shard = self._average(g_shard, world)
        clip = self.overlap_global_clip([g_shard])
        step = _next_step(state, skip)
        self._update(noop, skip, g_shard, state,
                     [leaf.numel() for leaf in leaves], padded, step, lr,
                     clip)
        flat_p = self._gather_params(state["master_shard"], world)
        new_state = self._finish(state, {**state, "step": _step_tensor(step)},
                                 residual, skip)
        out = _rebuild(params, _unflatten_like(flat_p[:n], leaves)), new_state
        return out if stats is None else out + (stats,)

    # reference-API hooks kept for drop-in use
    def set_global_scale(self, global_scale):
        self._global_scale = global_scale

    def complete_reductions(self):
        """Nothing to do: the reductions run inside ``step``."""
