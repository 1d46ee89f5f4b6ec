"""DistributedDataParallel over a process group.

Counterpart of ``apex_tpu/parallel/distributed.py`` (reference
apex/parallel/distributed.py:131-643): the gradient all-reduce with the
reference's options, ``allreduce_always_fp32``, ``gradient_average``,
``gradient_predivide_factor`` and ``message_size`` bucketing, plus the
compressed payloads of :mod:`apex_tpu_torch.parallel.compression`
(``compress=None|"bf16"|"int8"|"int4"``, error feedback in the int
modes). Collectives run on ``torch.distributed`` over the axis's process
group (:mod:`apex_tpu_torch.parallel.groups`; ``"dp"`` is the default
group), synchronously, on the caller's stream.

Gradients are a tensor, or a dict or list of them (nested too). A dict
flattens in sorted key order, as ``jax.tree_util`` flattens it, and a
list in its own order; since a bucket is one quantization grid, that
order decides which leaves share a scale. Results come back in the
input's structure.

    ddp = DistributedDataParallel(axis_name="dp", compress="int4")
    residual = None
    ...
    loss.backward()
    grads, residual = ddp.sync([p.grad for p in params], residual)
    for p, g in zip(params, grads):
        p.grad.copy_(g)

``numerics=`` (True or a grouping depth) appends per-module gradient
statistics (:mod:`apex_tpu_torch.telemetry.numerics`, K7 on the card) to
what ``sync`` returns: ``grads/<prefix>`` of the local pre-compression
gradients and ``synced/<prefix>`` of the synced ones. ``sync`` runs under
the ``ddp/sync`` span and every collective is accounted in
:mod:`apex_tpu_torch.telemetry.comm`; ``memory_report`` measures a step
(:func:`apex_tpu_torch.telemetry.memory.step_memory`).

Not here yet: ``expert_param_predicate`` and tuple axes (expert
parallelism, ROADMAP item 6); each raises, naming its item.
"""

import functools
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from apex_tpu_torch.parallel import compression
from apex_tpu_torch.parallel.compression import init_residual
from apex_tpu_torch.parallel.groups import axis_group
from apex_tpu_torch.telemetry import comm as _telemetry_comm
from apex_tpu_torch.telemetry import numerics as _numerics
from apex_tpu_torch.telemetry import trace as _telemetry_trace


def _numerics_depth(numerics):
    """Resolve the ``numerics=`` knob: True -> env/default grouping
    depth, an int -> that depth."""
    return (_numerics.default_prefix_depth() if numerics is True
            else int(numerics))


def _grad_sync_stats(local_grads, synced_grads, numerics):
    """The two stat groups the DDP ``numerics=`` knob exposes:
    ``grads/<prefix>`` from the LOCAL PRE-COMPRESSION gradients (an int8
    sum can launder a replica's NaN into finite wire garbage, so only the
    local view sees the true non-finite source) and ``synced/<prefix>``
    from the synced (dequantized) gradients, so the quantization error
    shows as the rms delta per module prefix. One dict, its table in
    sorted key order."""
    depth = _numerics_depth(numerics)
    return _numerics.merge(
        _numerics.tree_stats(local_grads, prefix_depth=depth,
                             prefix="grads"),
        _numerics.tree_stats(synced_grads, prefix_depth=depth,
                             prefix="synced"))


def _refuse_expert(expert_param_predicate):
    if expert_param_predicate is not None:
        raise NotImplementedError(
            "expert_param_predicate (expert shards reduced over their own "
            "replica set) comes with expert parallelism, ROADMAP item 6")


def _leaves(tree):
    """The tensors of ``tree`` in ``jax.tree_util`` order: a dict by
    sorted key, a list or tuple in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    raise TypeError(f"expected a tensor, dict or list of tensors, got "
                    f"{type(tree).__name__}")


def _rebuild(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in :func:`_leaves`'s
    order); dicts keep their own key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def flatten(tensors):
    """Coalesce a list of SAME-dtype tensors into one flat buffer
    (apex_C.flatten). All leaves share one dtype, so
    ``unflatten(flatten(ts), ts)`` round-trips bit for bit; a mixed list
    raises instead of promoting to the widest dtype."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1:
        names = sorted(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(
            f"flatten: mixed dtypes {names}; flatten/unflatten round-trip "
            f"exactly only over a single dtype — group leaves with "
            f"plan_buckets first")
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat, tensors):
    """Split a flat buffer into views shaped like ``tensors``
    (apex_C.unflatten), cast back to each one's dtype (a buffer that came
    back from a wider comm dtype)."""
    outs, off = [], 0
    for t in tensors:
        n = t.numel()
        outs.append(flat[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return outs


def assign_buckets(sizes, cap):
    """Bucket id of each leaf size, greedy and in order: a bucket closes
    when the next leaf would take it past ``cap`` elements; a leaf larger
    than ``cap`` gets a bucket of its own (apex_tpu._C.assign_buckets)."""
    if cap <= 0:
        raise ValueError("assign_buckets: cap must be positive")
    out, acc, bucket, empty = [], 0, 0, True
    for sz in sizes:
        if not empty and acc + sz > cap:
            bucket += 1
            acc = 0
            empty = True
        acc += sz
        empty = False
        out.append(bucket)
    return out


def plan_buckets(leaves, message_size=10000000):
    """Group the flat leaf list into dtype-segregated, in-order buckets
    capped at ``message_size`` elements (reference distributed.py:287-320
    ``sync_bucket_structure``). Returns a list of buckets, each a list of
    leaf indices."""
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    buckets = []
    for idxs in by_dtype.values():
        ids = assign_buckets([leaves[i].numel() for i in idxs], message_size)
        cur, cur_id = [], 0
        for i, b in zip(idxs, ids):
            if b != cur_id:
                buckets.append(cur)
                cur, cur_id = [], b
            cur.append(i)
        if cur:
            buckets.append(cur)
    return buckets


def _no_axes(axis_name):
    """An empty tuple of axes: the single-replica no-op."""
    return isinstance(axis_name, (tuple, list)) and len(axis_name) == 0


def _div(x, value):
    """``x / value`` in x's dtype as an IEEE division by a tensor (on CUDA
    a division by a Python scalar is a product with its reciprocal)."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def all_reduce_flag(flag, axis_name="dp"):
    """Global OR of a scalar fault/overflow flag over the replica set: one
    fp32 sum (flags are non-negative). ``None`` or an empty tuple is the
    single-replica no-op."""
    flag = torch.as_tensor(flag, dtype=torch.float32)
    if axis_name is None or _no_axes(axis_name):
        return flag
    flag = flag.clone()
    group = axis_group(axis_name)
    _telemetry_comm.record_collective(
        "psum", elements=flag.numel(), dtype=flag.dtype, axis_name=axis_name,
        world=dist.get_world_size(group))
    dist.all_reduce(flag, group=group)
    return flag


def _psum_with_policy(g, axis_name, allreduce_always_fp32, gradient_average,
                      gradient_predivide_factor, compress=None,
                      compress_block_size=compression.BLOCK_SIZE,
                      residual=None):
    """The DDP reduction policy (reference distributed.py:429-479
    ``allreduce_bucket``): optional fp32 comm dtype, predivide before and
    postdivide after the sum, cast back to the input's dtype. A compress
    mode owns the comm dtype, so it overrides ``allreduce_always_fp32``;
    the int modes return ``(g, new_residual)``, the residual living in the
    pre-sum, predivided domain (keep ``gradient_predivide_factor`` fixed
    across steps)."""
    stateful = compression.needs_residual(compress)
    if _no_axes(axis_name):
        return (g, residual) if stateful else g
    group = axis_group(axis_name)
    orig, orig_dtype = g, g.dtype
    if compress is None and allreduce_always_fp32:
        g = g.float()
    if gradient_predivide_factor != 1.0:
        g = _div(g, gradient_predivide_factor)
    if compress is not None:
        shape = g.shape
        flat_r = None if residual is None else residual.reshape(-1)
        g, new_residual = compression.psum_compressed(
            g.reshape(-1), group, mode=compress, residual=flat_r,
            block_size=compress_block_size)
        g = g.reshape(shape)
    else:
        if g is orig:  # the sum is in place: never on the caller's tensor
            g = g.clone()
        _telemetry_comm.record_collective(
            "psum", elements=g.numel(), dtype=g.dtype, axis_name=axis_name,
            world=dist.get_world_size(group))
        dist.all_reduce(g, group=group)
    if gradient_average:
        g = _div(g, dist.get_world_size(group) / gradient_predivide_factor)
    g = g.to(orig_dtype)
    return (g, new_residual.reshape(g.shape)) if stateful else g


def all_reduce_gradients(grads, axis_name="dp", *, allreduce_always_fp32=False,
                         gradient_average=True, gradient_predivide_factor=1.0,
                         expert_param_predicate=None, expert_axis_name="dp",
                         compress=None,
                         compress_block_size=compression.BLOCK_SIZE,
                         residual=None, numerics=None):
    """All-reduce every gradient leaf on its own (the per-leaf DDP path).
    With ``compress="int8"`` or ``"int4"`` the return is ``(grads,
    residual)``: carry the residual to the next call (``None`` starts
    from zeros). ``numerics=True`` (or a grouping depth) appends the
    per-module statistics of :func:`_grad_sync_stats` as the last
    return element."""
    _refuse_expert(expert_param_predicate)
    if numerics:
        out = all_reduce_gradients(
            grads, axis_name, allreduce_always_fp32=allreduce_always_fp32,
            gradient_average=gradient_average,
            gradient_predivide_factor=gradient_predivide_factor,
            compress=compress, compress_block_size=compress_block_size,
            residual=residual)
        if compression.needs_residual(compress):
            synced, new_residual = out
            return synced, new_residual, _grad_sync_stats(grads, synced,
                                                          numerics)
        return out, _grad_sync_stats(grads, out, numerics)
    policy = functools.partial(
        _psum_with_policy, axis_name=axis_name,
        allreduce_always_fp32=allreduce_always_fp32,
        gradient_average=gradient_average,
        gradient_predivide_factor=gradient_predivide_factor,
        compress=compress, compress_block_size=compress_block_size)
    leaves = _leaves(grads)
    if not compression.needs_residual(compress):
        return _rebuild(grads, [policy(g) for g in leaves])
    if residual is None:
        residual = init_residual(grads)
    out = [policy(g, residual=r) for g, r in zip(leaves, _leaves(residual))]
    return (_rebuild(grads, [g for g, _ in out]),
            _rebuild(grads, [r for _, r in out]))


def all_reduce_gradients_bucketed(grads, axis_name="dp", *,
                                  message_size=10000000,
                                  allreduce_always_fp32=False,
                                  gradient_average=True,
                                  gradient_predivide_factor=1.0,
                                  expert_param_predicate=None,
                                  expert_axis_name="dp",
                                  compress=None,
                                  compress_block_size=compression.BLOCK_SIZE,
                                  residual=None):
    """Bucketed DDP all-reduce: flatten same-dtype runs of leaves into
    ``message_size``-element buckets and reduce each bucket as ONE
    collective (reference allreduce_bucket over apex_C-flattened
    buffers). ``compress`` works per bucket: one quantization grid per
    flat buffer. With ``"int8"`` or ``"int4"`` the return is ``(grads,
    residual)``, the residual leaf-shaped (flattened into each bucket
    beside the gradients), so the same residual works for either sync
    path. Each bucket runs under a profiler range
    ``ddp_allreduce_bucket_<k>``."""
    _refuse_expert(expert_param_predicate)
    stateful = compression.needs_residual(compress)
    leaves = _leaves(grads)
    if stateful:
        if residual is None:
            residual = init_residual(grads)
        res_leaves = _leaves(residual)
    out, out_res = [None] * len(leaves), [None] * len(leaves)
    for k, bucket in enumerate(plan_buckets(leaves, message_size)):
        with record_function(f"ddp_allreduce_bucket_{k}"):
            members = [leaves[i] for i in bucket]
            flat = flatten(members)
            if stateful:
                res_members = [res_leaves[i] for i in bucket]
                flat, flat_r = _psum_with_policy(
                    flat, axis_name, allreduce_always_fp32, gradient_average,
                    gradient_predivide_factor, compress=compress,
                    compress_block_size=compress_block_size,
                    residual=flatten(res_members))
                for i, piece in zip(bucket, unflatten(flat_r, res_members)):
                    out_res[i] = piece
            else:
                flat = _psum_with_policy(
                    flat, axis_name, allreduce_always_fp32, gradient_average,
                    gradient_predivide_factor, compress=compress,
                    compress_block_size=compress_block_size)
            for i, piece in zip(bucket, unflatten(flat, members)):
                out[i] = piece
    if stateful:
        return _rebuild(grads, out), _rebuild(grads, out_res)
    return _rebuild(grads, out)


def broadcast_params(params, axis_name="dp"):
    """Make parameters bitwise identical across the group by broadcasting
    rank 0's, in place (PyTorch's idiom; the DDP constructor's broadcast,
    reference distributed.py:257). Returns ``params``."""
    group = axis_group(axis_name)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for p in _leaves(params):
            dist.broadcast(p, src=src, group=group)
    return params


def _sync_grad(grad, group, average):
    grad = grad.clone()
    dist.all_reduce(grad, group=group)
    if average:
        grad = _div(grad, dist.get_world_size(group))
    return grad


_NEEDS_MODULE = ("DistributedDataParallel: the module-wrapping mode takes an "
                 "nn.Module, DistributedDataParallel(module); for gradients "
                 "of anything else call .sync(grads) after backward")


class DistributedDataParallel:
    """Gradient sync over a process group, in two modes.

    1. ``sync`` (hook parity): bucketed (``message_size``) or per leaf
       (``message_size=None``), optionally compressed::

         ddp = DistributedDataParallel(axis_name="dp")
         grads = ddp.sync(grads)

    2. Module wrapping: ``DistributedDataParallel(module)`` registers a
       hook on every parameter of the ``nn.Module``, so after backward
       each ``p.grad`` is the gradient averaged over the group
       (uncompressed, as JAX's ``_ddp_bwd``); ``ddp(x)`` calls the
       module. A bare function is refused: wrap it in an ``nn.Module``
       whose parameters are its inputs, or call ``sync`` after backward.
    """

    def __init__(self, module: Optional[torch.nn.Module] = None,
                 message_size: int = 10000000,
                 delay_allreduce: bool = False, shared_param: Any = None,
                 allreduce_trigger_params: Any = None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators: Any = None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 gradient_average_split_factor: Any = None,
                 prof: bool = False,
                 axis_name: str = "dp",
                 expert_param_predicate: Optional[Callable] = None,
                 expert_axis_name: str = "dp",
                 compress: Optional[str] = None,
                 compress_block_size: int = compression.BLOCK_SIZE,
                 numerics=None):
        _refuse_expert(expert_param_predicate)
        if module is not None and not isinstance(module, torch.nn.Module):
            raise TypeError(_NEEDS_MODULE)
        if compress not in (None, "bf16", *compression.RESIDUAL_MODES):
            raise ValueError(f"unknown compression mode {compress!r}")
        self.module = module
        self.axis_name = axis_name
        self.message_size = message_size
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        # None | "bf16" | "int8" | "int4"; the int modes make .sync
        # stateful: it returns (grads, residual) and the caller carries
        # the residual to the next step
        self.compress = compress
        self.compress_block_size = compress_block_size
        # per-module statistics appended to what .sync returns
        self.numerics = numerics
        self._hooks = []
        if module is not None:
            group = axis_group(axis_name)
            for p in module.parameters():
                if p.requires_grad:
                    self._hooks.append(p.register_hook(functools.partial(
                        _sync_grad, group=group, average=gradient_average)))

    def init_residual(self, grads_or_params):
        """Zero error-feedback state for ``compress="int8"``/``"int4"``,
        shaped like the gradients."""
        return init_residual(grads_or_params)

    def memory_report(self, step, *args, **kwargs):
        """Memory accounting of the step this DDP instance syncs inside:
        ``step(*args, **kwargs)`` runs once, measured
        (:func:`apex_tpu_torch.telemetry.memory.step_memory`: the bytes
        live before it, left after it, its peak, the ``memory/
        hbm_headroom`` gauge), and the report is tagged with the sync
        config. Returns None without a card."""
        from apex_tpu_torch.telemetry import memory as _memory

        report = _memory.step_memory(step, *args, **kwargs)
        if report is not None:
            report = dict(report, compress=self.compress or "none",
                          axis_name=str(self.axis_name))
        return report

    def sync(self, grads, residual=None):
        """Gradient all-reduce honoring ``message_size`` (``None``: per
        leaf). With ``compress="int8"`` or ``"int4"`` returns ``(grads,
        residual)``; pass the previous step's residual in (``None``
        starts from zeros, step 0 of error feedback). With ``numerics=``
        set at construction, the per-module statistics (``grads/*`` of
        the local pre-compression gradients, ``synced/*`` of the synced
        ones) are appended as the last return element. Runs under the
        ``ddp/sync`` span (a profiler range by that name)."""
        kw = dict(allreduce_always_fp32=self.allreduce_always_fp32,
                  gradient_average=self.gradient_average,
                  gradient_predivide_factor=self.gradient_predivide_factor)
        if self.compress is not None:
            kw.update(compress=self.compress,
                      compress_block_size=self.compress_block_size)
            if compression.needs_residual(self.compress):
                kw["residual"] = residual
        with _telemetry_trace.span("ddp/sync",
                                   compress=self.compress or "none",
                                   bucketed=bool(self.message_size),
                                   numerics=bool(self.numerics)):
            if self.message_size:
                out = all_reduce_gradients_bucketed(
                    grads, self.axis_name, message_size=self.message_size,
                    **kw)
            else:
                out = all_reduce_gradients(grads, self.axis_name, **kw)
            if not self.numerics:
                return out
            if compression.needs_residual(self.compress):
                synced, new_residual = out
                return synced, new_residual, _grad_sync_stats(
                    grads, synced, self.numerics)
            return out, _grad_sync_stats(grads, out, self.numerics)

    def __call__(self, *args, **kwargs):
        """Call the wrapped module: DDP is transparent in forward, and its
        parameters' hooks average the gradients in backward."""
        if self.module is None:
            raise TypeError(_NEEDS_MODULE)
        return self.module(*args, **kwargs)


class Reducer:
    """Manual-trigger gradient reducer (reference distributed.py:91-128:
    the user calls ``reduce`` when ready)."""

    def __init__(self, module_or_grads_list=None, axis_name="dp"):
        self.axis_name = axis_name

    def reduce(self, grads, **kwargs):
        return all_reduce_gradients(grads, self.axis_name, **kwargs)
