"""The overlapped backward/collective training step.

Counterpart of ``apex_tpu/parallel/overlap.py``. The caller splits the
model into K *segments*, ``segments[k](params_k, carry) -> carry``, the
last returning the scalar loss. :class:`OverlappedDataParallel` runs the
forward through the chain, then the backward segment by segment in
reverse, and issues each gradient bucket's collective as soon as its
segment's gradients exist, before the earlier segments' backward: a
bucket never spans a segment (:func:`plan_overlap`), so it is ready when
its segment is done. :func:`overlapped_zero_step` does the same for the
ZeRO optimizers, each bucket's reduce-scatter, sharded update and gather.

In PyTorch's idiom the segmented backward is: each segment's forward runs
on its params as fresh leaves and on the previous segment's output
detached (the first segment takes ``x`` as it is, e.g. int tokens); the
backward is ``torch.autograd.grad`` of segment k's output for its params
and its input carry, with the carry's gradient from segment k + 1 as
``grad_outputs``. The collectives run on the caller's stream, in line,
in emission order (the last segment's buckets first).

The int modes keep their error-feedback residual in the quantization
block domain (``[nblocks, block]`` a bucket, :meth:`init_residual`), and
``fold_average=True`` folds the ``1/world`` averaging into the dequant
scales (``compression.psum_compressed_blocks(scale_mult=)``). As in
JAX, ``compress="int4"`` takes the same int8 block path (reproduced, not
fixed: ``apex_tpu/parallel/overlap.py:217-231``).

Profiler ranges: ``ddp_overlap_segment_<k>`` around segment k's backward,
``ddp_overlap_bucket_<n>`` around bucket n's collective (buckets numbered
in emission order). As the DDP module, the collectives run at world 1
too.

Composition with the guard (``resilience.guarded_update``):
``guard_flag=True`` also returns the LOCAL pre-compression non-finite
flag (K7's counts, on the device) for the one fp32 all-reduce, and the
bucket-domain residual reverts on a skipped step like any other state.
``numerics=`` appends the same ``grads/*`` + ``synced/*`` statistics the
DDP knob produces.
"""

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from apex_tpu_torch.parallel import compression
from apex_tpu_torch.parallel.distributed import (
    _div,
    _leaves,
    _numerics_depth,
    _rebuild,
    flatten,
    plan_buckets,
    unflatten,
)
from apex_tpu_torch.parallel.groups import axis_group
from apex_tpu_torch.telemetry import numerics as _numerics


class Bucket(NamedTuple):
    """One planned bucket: which leaves of its segment it coalesces
    (``plan_buckets`` indices), the flat element count, and the int8
    block-grid row count."""

    leaf_idx: tuple
    n: int
    nblocks: int


def plan_overlap(segment_params: Sequence[Any], *,
                 message_size: int = 10000000,
                 block_size: int = compression.BLOCK_SIZE):
    """Per segment, the dtype-segregated ``message_size``-capped grouping
    of ``plan_buckets``, never spanning a segment boundary: a tuple (per
    segment) of tuples of :class:`Bucket`."""
    plan = []
    for params in segment_params:
        leaves = _leaves(params)
        buckets = []
        if leaves:
            for idxs in plan_buckets(leaves, message_size):
                n = int(sum(leaves[i].numel() for i in idxs))
                buckets.append(Bucket(tuple(idxs), n,
                                      compression.num_blocks(n, block_size)))
        plan.append(tuple(buckets))
    return tuple(plan)


def _forward(segments, segment_params, x):
    """The forward through the chain with each segment's params as fresh
    leaves and its input carry detached: ``(loss, [(segment k's param
    leaves, its input carry or None, its output)])``."""
    if len(segments) != len(segment_params):
        raise ValueError(f"{len(segments)} segment fns vs "
                         f"{len(segment_params)} param groups")
    carry, tape = x, []
    with torch.enable_grad():
        for k, (fn, params) in enumerate(zip(segments, segment_params)):
            leaves = [p.detach().requires_grad_() for p in _leaves(params)]
            inp = None
            if k:
                inp = carry.detach().requires_grad_()
                carry = inp
            carry = fn(_rebuild(params, leaves), carry)
            tape.append((leaves, inp, carry))
    if carry.dim() != 0:
        raise ValueError(f"the last segment must return a scalar loss, got "
                         f"shape {tuple(carry.shape)}")
    return carry, tape


def _backward(tape, k, ct):
    """Segment k's backward: (its params' gradients, the gradient of its
    input carry or None). Params a segment does not use get zeros, as
    ``jax.vjp`` gives them."""
    leaves, inp, out = tape[k]
    wrt = leaves + ([inp] if inp is not None else [])
    grads = torch.autograd.grad(out, wrt, grad_outputs=ct, allow_unused=True)
    gk = [torch.zeros_like(p) if g is None else g
          for p, g in zip(leaves, grads)]
    tape[k] = None  # the segment's graph is freed with its tensors
    return gk, (grads[-1] if inp is not None else None)


class OverlappedDataParallel:
    """DDP gradient sync restructured for backward/collective overlap:
    :class:`~apex_tpu_torch.parallel.DistributedDataParallel`'s reduction
    policy (``gradient_average``, ``gradient_predivide_factor``,
    ``compress``, ``message_size``) over a SEGMENTED model, whose backward
    :meth:`value_and_sync` runs itself.

    ``fold_average=True`` (default) folds the ``1/world`` averaging into
    the int8 dequant scales, one fp32 rounding per element away from the
    bucketed DDP's divide after the sum; ``False`` keeps that order."""

    def __init__(self, axis_name="dp", message_size: int = 10000000,
                 compress: Optional[str] = None,
                 compress_block_size: int = compression.BLOCK_SIZE,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 fold_average: bool = True, guard_flag: bool = False,
                 numerics=None):
        if compress not in (None, "bf16", "int8", "int4"):
            raise ValueError(f"unknown compression mode {compress!r}")
        self.axis_name = axis_name
        self.message_size = message_size
        self.compress = compress
        self.compress_block_size = compress_block_size
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.fold_average = fold_average
        self.guard_flag = guard_flag
        self.numerics = numerics

    # -- planning / state ------------------------------------------------

    def plan(self, segment_params):
        return plan_overlap(segment_params, message_size=self.message_size,
                            block_size=self.compress_block_size)

    def init_residual(self, segment_params):
        """Zero error-feedback state for ``compress="int8"``/``"int4"``: a
        tuple (per segment) of tuples of ``[nblocks, block]`` fp32 zeros,
        on the params' device."""
        bs = self.compress_block_size
        out = []
        for params, seg in zip(segment_params,
                               self.plan(segment_params)):
            leaves = _leaves(params)
            device = leaves[0].device if leaves else None
            out.append(tuple(torch.zeros(b.nblocks, bs, dtype=torch.float32,
                                         device=device) for b in seg))
        return tuple(out)

    def residual_to_tree(self, segment_params, residual):
        """Bucket-domain residual -> leaf-shaped trees (one per segment),
        the zero pad tails stripped: the layout the DDP paths carry."""
        out = []
        for params, seg_plan, seg_res in zip(
                segment_params, self.plan(segment_params), residual):
            leaves = _leaves(params)
            res_leaves = [None] * len(leaves)
            for bucket, r2d in zip(seg_plan, seg_res):
                flat = r2d.reshape(-1)[:bucket.n]
                for i, piece in zip(bucket.leaf_idx, unflatten(
                        flat, [leaves[i] for i in bucket.leaf_idx])):
                    res_leaves[i] = piece
            out.append(_rebuild(params, res_leaves))
        return out

    # -- the per-bucket collective ---------------------------------------

    def _sync_flat(self, flat, res2d):
        """One bucket's collective: ``(synced flat, new_residual2d or
        None)``, the averaging policy applied in ``_psum_with_policy``'s
        order unless ``fold_average`` moved the divide into the scales."""
        group = axis_group(self.axis_name)
        orig_dtype = flat.dtype
        if self.gradient_predivide_factor != 1.0:
            flat = _div(flat, self.gradient_predivide_factor)
        divisor = (dist.get_world_size(group) / self.gradient_predivide_factor
                   if self.gradient_average else None)
        if compression.needs_residual(self.compress):
            x2d = compression.pad_to_blocks(flat, self.compress_block_size)
            if res2d is not None:
                x2d = x2d + res2d
            fold = self.fold_average and divisor is not None
            out, err = compression.psum_compressed_blocks(
                x2d, self.axis_name,
                scale_mult=1.0 / divisor if fold else None)
            out = out[:flat.shape[0]]
            if divisor is not None and not fold:
                out = _div(out, divisor)
            return out.to(orig_dtype), err
        wire = torch.bfloat16 if self.compress == "bf16" else flat.dtype
        out = flat.to(wire, copy=True)
        dist.all_reduce(out, group=group)
        out = out.to(flat.dtype)
        if divisor is not None:
            out = _div(out, divisor)
        return out, None

    # -- the overlapped step ---------------------------------------------

    def value_and_sync(self, segments: Sequence[Callable],
                       segment_params: Sequence[Any], x, residual=None):
        """Forward through the segment chain, then the backward segment by
        segment in reverse with each ready bucket's collective issued
        before the earlier segments' backward.

        Returns, in order: ``loss`` (detached), ``synced`` (a list of
        per-segment gradient trees, the averaging policy applied), then
        ``new_residual`` (bucket domain, in the int modes;
        ``residual=None`` starts from zeros), then the local non-finite
        ``flag`` (iff ``guard_flag``), then the statistics dict (iff
        ``numerics``; top-level leaf names should be unique across
        segments)."""
        K = len(segments)
        plan = self.plan(segment_params)
        is_int = compression.needs_residual(self.compress)
        if is_int and residual is None:
            residual = self.init_residual(segment_params)
        loss, tape = _forward(segments, segment_params, x)

        synced, new_res, local = [None] * K, [None] * K, [None] * K
        ct = torch.ones_like(loss)
        bucket_no = sum(len(s) for s in plan)
        for k in reversed(range(K)):
            with record_function(f"ddp_overlap_segment_{k}"):
                gk, ct = _backward(tape, k, ct)
            if self.guard_flag or self.numerics:
                local[k] = _rebuild(segment_params[k], list(gk))
            out_leaves, seg_res = list(gk), []
            # buckets numbered in emission order: the last segment's first
            bucket_no -= len(plan[k])
            for bi, bucket in enumerate(plan[k]):
                with record_function(f"ddp_overlap_bucket_{bucket_no + bi}"):
                    members = [gk[i] for i in bucket.leaf_idx]
                    out, err2d = self._sync_flat(
                        flatten(members), residual[k][bi] if is_int else None)
                    for i, piece in zip(bucket.leaf_idx,
                                        unflatten(out, members)):
                        out_leaves[i] = piece
                    seg_res.append(err2d)
            synced[k] = _rebuild(segment_params[k], out_leaves)
            new_res[k] = tuple(seg_res)
        outs = (loss.detach(), synced)
        if is_int:
            outs = outs + (tuple(new_res),)
        if self.guard_flag:
            from apex_tpu_torch.resilience.guard import nonfinite_flag

            outs = outs + (nonfinite_flag(local, loss.device),)
        if self.numerics:
            depth = _numerics_depth(self.numerics)
            stats = []
            for k in range(K):
                stats.append(_numerics.tree_stats(
                    local[k], prefix_depth=depth, prefix="grads"))
                stats.append(_numerics.tree_stats(
                    synced[k], prefix_depth=depth, prefix="synced"))
            outs = outs + (_numerics.merge(*stats),)
        return outs


# ---------------------------------------------------------------------------
# ZeRO: each bucket's reduce-scatter and sharded update in the backward
# ---------------------------------------------------------------------------

def overlapped_zero_step(segments: Sequence[Callable],
                         segment_params: Sequence[Any], opt, state, x, *,
                         lr=None, found_inf=None, scale: float = 1.0):
    """The ZeRO form of :meth:`OverlappedDataParallel.value_and_sync`: the
    segmented backward with each bucket's reduce-scatter AND its sharded
    update and gather issued as soon as the segment's gradients exist.

    ``opt`` is a ``DistributedFusedAdam``/``DistributedFusedLAMB`` made
    with ``overlap=True``; ``state`` comes from ``opt.init(segment_params)``
    (its bucket shards updated in place). LAMB with ``max_grad_norm > 0``
    needs the global gradient norm before any update: its scatters still
    follow each segment's backward, its updates run after the walk.

    Returns ``(loss, new_segment_params, new_state)``, plus the
    ``grads/*`` statistics of the local gradients last when
    ``opt.numerics`` is set."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
        _BucketStep,
    )

    if not getattr(opt, "overlap", False):
        raise ValueError("overlapped_zero_step needs an optimizer "
                         "constructed with overlap=True")
    loss, tape = _forward(segments, segment_params, x)
    walk = _BucketStep(opt, state, segment_params, lr=lr, found_inf=found_inf)
    numerics = getattr(opt, "numerics", None)
    stats = []
    ct = torch.ones_like(loss)
    bucket_no = sum(len(s) for s in walk.plan)
    for k in reversed(range(len(segments))):
        with record_function(f"ddp_overlap_segment_{k}"):
            g_leaves, ct = _backward(tape, k, ct)
        if numerics:
            stats.append(_numerics.tree_stats(
                _rebuild(segment_params[k], list(g_leaves)),
                prefix_depth=_numerics_depth(numerics), prefix="grads"))
        bucket_no -= len(walk.plan[k])
        walk.reduce(k, g_leaves, scale, numbered=lambda bi, n=bucket_no:
                    record_function(f"ddp_overlap_bucket_{n + bi}"))
        del g_leaves
    new_params, new_state = walk.finish()
    if numerics:
        return loss.detach(), new_params, new_state, _numerics.merge(*stats)
    return loss.detach(), new_params, new_state
