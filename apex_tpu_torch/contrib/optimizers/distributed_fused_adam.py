"""DistributedFusedAdam: ZeRO-sharded Adam over the data-parallel axis.

Counterpart of ``apex_tpu/contrib/optimizers/distributed_fused_adam.py``
(reference apex/contrib/optimizers/distributed_fused_adam.py): the
parameters are flattened into one fp32 vector, padded and cut into equal
shards over the process group of ``axis_name``. Each rank keeps the fp32
master, ``exp_avg`` and ``exp_avg_sq`` of its own shard only (the ZeRO
memory saving), and a step is

1. the flat gradient reduce-scattered (``dist.reduce_scatter_tensor``, or
   the compressed forms of :mod:`apex_tpu_torch.parallel.compression`
   with the error-feedback residual in the state) and averaged;
2. one launch of the Adam kernel (#12, ``kernels/optim.py`` ``adam``) on
   the local shard;
3. the updated shard all-gathered (bf16, int8 or int4 compressed, or
   fp32) back into full parameters.

The interface is JAX's, functional: ``state = opt.init(params)`` is a
dict of tensors under JAX's keys (``step``, ``master_shard``,
``exp_avg_shard``, ``exp_avg_sq_shard`` and, with int8/int4 gradients,
``grad_residual``), and ``new_params, state = opt.step(grads, state,
params)``. Params and grads are a tensor, or a dict or list of them,
flattened in ``jax.tree_util`` order (dicts by sorted key); the new
params come back in that structure, each a new tensor (never a view of
the master shard). In PyTorch's idiom the master and moment shards are
updated **in place** and the returned state holds the same tensors;
clone them to keep an earlier state.

    opt = DistributedFusedAdam(lr=1e-4, compress=True)
    state = opt.init([p.detach() for p in model.parameters()])
    ...
    loss.backward()
    new, state = opt.step([p.grad for p in model.parameters()], state,
                          list(model.parameters()))
    torch._foreach_copy_(list(model.parameters()), new)

**The step counter** ``state["step"]`` is a 0-d int32 tensor on the CPU,
so the bias corrections (``1 - beta ** step`` in fp32, the value XLA's
fp32 power gives JAX's jitted step; ``ops.multi_tensor.bias_corrections``)
are computed on the host without a synchronisation. ``found_inf`` and
``scale`` are ZeRO's own arguments, as in JAX: ``found_inf`` (a number
or a one-element tensor) non-zero skips the step, leaving the params,
the state and ``step`` as they were; it is read on the host, one
synchronisation a step when it is a CUDA tensor, and the kernel reads it
as its ``noop`` flag. The gradients are divided by ``scale`` first (an
IEEE division, as JAX's).

**World size 1.** As JAX's, the optimizer asks
:func:`apex_tpu_torch.parallel.groups.axis_size` for the world and at 1
(one rank, or no process group) skips its reduce-scatter and gather:
the step is the Adam update of the whole flat vector, and an int8
``grad_residual`` stays as it was. DDP and
:class:`~apex_tpu_torch.parallel.OverlappedDataParallel` do run their
collectives at world 1 (``parallel/groups.py``); ZeRO follows JAX here.

``overlap=True`` partitions the flat state into ``message_size``-element
buckets per segment (:func:`plan_zero_overlap`); ``init``/``step`` then
also take a list of per-segment param trees, and
:func:`apex_tpu_torch.parallel.overlap.overlapped_zero_step` runs each
bucket's reduce-scatter, update (one #12 launch a bucket) and gather as
soon as its segment's backward is done.

The elastic state (``state_dict_full`` / ``load_state_dict_resharded``,
:func:`consolidate_zero_state`, :func:`reshard_zero_state` and their
bucketed and 2-D forms) is JAX's host math on numpy arrays: the same
format-1/2 dicts, so a state written by either package loads into the
other. The 3-D (pipe-axis) forms wait for pipeline parallelism (ROADMAP
item 6) and raise, naming it. ``numerics=`` (True or a grouping depth)
appends the ``grads/*`` statistics of the local gradients
(:mod:`apex_tpu_torch.telemetry.numerics`) to what ``step`` returns;
:func:`zero_state_bytes` lands the ``memory/zero_state_*`` gauges and a
``memory`` event in the telemetry registry.
"""

import contextlib
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from apex_tpu_torch.kernels import optim as _koptim
from apex_tpu_torch.ops.multi_tensor import bias_corrections
from apex_tpu_torch.parallel import compression, groups
from apex_tpu_torch.parallel.distributed import (
    _div,
    _leaves,
    _numerics_depth,
    _rebuild,
    plan_buckets,
)
from apex_tpu_torch.telemetry import numerics as _numerics
from apex_tpu_torch.telemetry.registry import get_registry

_SHARDS = (("master_shard", "master"), ("exp_avg_shard", "exp_avg"),
           ("exp_avg_sq_shard", "exp_avg_sq"))


def _refuse_pipe(what):
    raise NotImplementedError(
        f"{what}: the 3-D (data, model, pipe) ZeRO state comes with "
        f"pipeline parallelism, ROADMAP item 6")


# ---------------------------------------------------------------------------
# flat layout
# ---------------------------------------------------------------------------

def _flat_size(params):
    return int(sum(leaf.numel() for leaf in _leaves(params)))


def _flatten_f32(leaves, padded, scale=1.0):
    """The leaves as one new fp32 vector of ``padded`` elements, the tail
    zero, divided by ``scale`` as an IEEE division (JAX's ``flat /
    scale``; on CUDA a division by a Python scalar would be a product with
    its reciprocal)."""
    n = sum(leaf.numel() for leaf in leaves)
    device = leaves[0].device if leaves else None
    out = torch.empty(padded, dtype=torch.float32, device=device)
    if leaves:
        torch.cat([leaf.detach().reshape(-1) for leaf in leaves],
                  out=out[:n])
    out[n:].zero_()
    if scale != 1.0:
        out.div_(torch.full((), scale, dtype=torch.float32,
                            device=out.device))
    return out


def _unflatten_like(flat, leaves):
    """New tensors shaped like ``leaves`` from the front of ``flat``, each
    in its leaf's dtype: copies, so a returned parameter never aliases
    the master shard the next step updates in place."""
    outs, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        outs.append(flat[off:off + n].view(leaf.shape).to(leaf.dtype,
                                                          copy=True))
        off += n
    return outs


def _padded_size(n, world, grad_compress, param_compress, block_size):
    """Padded flat length for ``world``-way sharding: shards must be
    equal-length, and int8/int4 modes additionally need every rank's
    shard to cover whole quantization blocks."""
    align = world
    if any(m in ("int8", "int4") for m in (grad_compress, param_compress)):
        align *= block_size
    return ((n + align - 1) // align) * align


def _noop(found_inf, device):
    """(the one-element fp32 flag the kernel reads, whether the step is
    skipped): ``found_inf`` read on the host, a synchronisation when it is
    a CUDA tensor."""
    if found_inf is None:
        return torch.zeros(1, dtype=torch.float32, device=device), False
    flag = torch.as_tensor(found_inf, dtype=torch.float32).reshape(1)
    flag = flag.to(device)
    return flag, bool(flag.item() > 0)


def _next_step(state, skip):
    """JAX's ``step + where(noop > 0, 0, 1)``, on the host."""
    return int(state["step"]) + (0 if skip else 1)


def _step_tensor(step):
    return torch.tensor(step, dtype=torch.int32)


def _as_segments(tree_or_list):
    """Normalize ``params``/``grads`` to the segmented form: a list/tuple
    of containers (dicts, lists) passes through as segments, anything
    else, a plain list of tensors included, becomes one segment."""
    if isinstance(tree_or_list, (list, tuple)) and tree_or_list and all(
            not isinstance(t, torch.Tensor) for t in tree_or_list):
        return list(tree_or_list), True
    return [tree_or_list], False


# ---------------------------------------------------------------------------
# elastic state: host-side numpy math, JAX's format-1 dict
# ---------------------------------------------------------------------------

def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _global_flat(arr, padded, world, name):
    """Normalize one ZeRO state buffer to the host-global ``(padded,)``
    flat vector: accepts the concatenation of the per-rank shards
    (already ``(padded,)``), the ``(world, padded // world)`` per-rank
    stack, or a single-device ``(padded,)`` shard."""
    a = _np(arr)
    if a.ndim == 2:
        if a.shape != (world, padded // world):
            raise ValueError(
                f"{name}: stacked shards have shape {a.shape}, wanted "
                f"({world}, {padded // world})")
        a = a.reshape(-1)
    if a.shape != (padded,):
        raise ValueError(
            f"{name}: flat length {a.shape} does not match the padded "
            f"length {padded} for world={world} — wrong world, or a "
            f"state written with different compression alignment?")
    return a


def _header(optimizer, world, n, block_size, grad_compress,
            param_compress, step):
    return {"format": 1, "optimizer": optimizer, "world": int(world),
            "n_elements": n, "block_size": int(block_size),
            "grad_compress": grad_compress,
            "param_compress": param_compress,
            "step": _np(step).astype(np.int32).reshape(())}


def consolidate_zero_state(state, params, *, world, grad_compress=None,
                           param_compress=None,
                           block_size=compression.BLOCK_SIZE,
                           optimizer="zero"):
    """Host-side: the per-rank ZeRO shards -> one full, UNPADDED
    state_dict (the re-shardable canonical form).

    ``state``'s ``*_shard`` leaves are the ``(padded,)`` concatenation of
    the per-rank shards or a ``(world, padded // world)`` stack; the
    per-rank full-length residual is a ``(world, padded)`` stack. Returns
    fp32 ``master`` / ``exp_avg`` / ``exp_avg_sq`` of the logical length
    ``n``, the residual as the SUM over ranks (the only
    topology-invariant view) and the layout metadata. Bit-exact: values
    are copied, never re-rounded."""
    n = _flat_size(params)
    padded = _padded_size(n, world, grad_compress, param_compress,
                          block_size)
    full = _header(optimizer, world, n, block_size, grad_compress,
                   param_compress, state["step"])
    for src, dst in _SHARDS:
        full[dst] = _global_flat(state[src], padded, world, src)[:n]
    if state.get("grad_residual") is not None:
        full["grad_residual"] = _consolidated_residual(
            state["grad_residual"], padded, world)[:n]
    return full


def _consolidated_residual(res, padded, world):
    """The per-rank residuals' sum over ranks, ``(padded,)``: each rank
    adds its residual before the sum, so only the sum is
    topology-invariant."""
    res = _np(res)
    if res.ndim == 2:
        if res.shape != (world, padded):
            raise ValueError(
                f"grad_residual: stacked shape {res.shape}, wanted "
                f"({world}, {padded})")
        return res.sum(axis=0)
    if res.shape == (padded,):
        if world != 1:
            raise ValueError(
                f"grad_residual: got one ({padded},) vector for "
                f"world={world} — the per-rank residuals must be "
                f"stacked ({world}, {padded}); a single vector is "
                "only unambiguous at world=1")
        return res
    raise ValueError(
        f"grad_residual: shape {res.shape}, wanted "
        f"({world}, {padded}) or ({padded},) at world=1")


def _check_n(full, n):
    if full.get("n_elements") not in (None, n):
        raise ValueError(
            f"state_dict is for {full['n_elements']} elements, params "
            f"flatten to {n} — wrong model for this checkpoint")


def _warn_dropped(fn):
    warnings.warn(
        f"{fn}: the checkpoint carries an int8 error-feedback residual "
        f"but the target optimizer is not compressed — dropping the "
        f"residual (its error will re-enter the gradients once, bounded "
        f"by one quantization step)")


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def reshard_zero_state(full, params, *, world, grad_compress=None,
                       param_compress=None,
                       block_size=compression.BLOCK_SIZE, device=None):
    """Host-side: one full unpadded state_dict
    (:func:`consolidate_zero_state`) -> the host-global ZeRO state for a
    ``world``-way group, the shard padding recomputed for the new
    topology. Each ``*_shard`` is the ``(new_padded,)`` concatenation
    (rank r takes slice r of ``world``; ``world=1`` takes it whole) and
    ``grad_residual`` the ``(world, new_padded)`` stack with rank 0
    carrying the whole summed correction. Tensors on ``device`` (default
    the CPU); ``step`` a 0-d int32 CPU tensor."""
    n = _flat_size(params)
    _check_n(full, n)
    padded = _padded_size(n, world, grad_compress, param_compress,
                          block_size)

    def pad(v):
        a = np.asarray(_np(v), np.float32)
        if a.shape != (n,):
            raise ValueError(f"full state buffer has shape {a.shape}, "
                             f"wanted ({n},)")
        return np.pad(a, (0, padded - n))

    state = {"step": torch.from_numpy(
        _np(full["step"]).astype(np.int32).reshape(()))}
    for dst, src in _SHARDS:
        state[dst] = _tensor(pad(full[src]), device)
    written = full.get("grad_residual")
    if compression.needs_residual(grad_compress):
        rows = np.zeros((world, padded), np.float32)
        if written is not None:
            rows[0] = pad(written)
        state["grad_residual"] = _tensor(rows, device)
    elif written is not None:
        _warn_dropped("reshard_zero_state")
    return state


def _leaf_arrays_from_flat(flat, leaves):
    """Split a flat vector into arrays shaped like ``leaves`` (exact
    copies)."""
    outs, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        outs.append(np.asarray(flat[off:off + n]).reshape(tuple(leaf.shape)))
        off += n
    return outs


def _check_bucket_layout(state, plan):
    if not (isinstance(state, dict) and "buckets" in state):
        raise ValueError(
            "expected an overlap=True bucket-partitioned state "
            "({'step', 'buckets': ...})")
    buckets = state["buckets"]
    if len(buckets) != len(plan) or any(
            len(seg_state) != len(seg_plan)
            for seg_state, seg_plan in zip(buckets, plan)):
        raise ValueError(
            f"bucket state layout {[len(s) for s in buckets]} does not "
            f"match the plan {[len(s) for s in plan]} derived from the "
            f"params — wrong params/segments, message_size, or world "
            f"for this state")


def consolidate_zero_overlap_state(state, params, *, world,
                                   grad_compress=None,
                                   param_compress=None,
                                   block_size=compression.BLOCK_SIZE,
                                   message_size=10000000,
                                   optimizer="zero"):
    """Host-side: an ``overlap=True`` bucket-partitioned ZeRO state ->
    the SAME full, unpadded format-1 state_dict
    :func:`consolidate_zero_state` produces. Each bucket's leaves follow
    the host-global layout (``*_shard`` concatenated or stacked over
    ranks, the residual a ``(world, padded)`` stack); the plan is
    recomputed from ``params`` (a tree, or a list of segment trees),
    ``world`` and ``message_size`` and checked against the state."""
    segs, _ = _as_segments(params)
    plan = plan_zero_overlap(segs, world=world, grad_compress=grad_compress,
                             param_compress=param_compress,
                             block_size=block_size,
                             message_size=message_size)
    _check_bucket_layout(state, plan)
    keys = ("master", "exp_avg", "exp_avg_sq", "grad_residual")
    slots = {key: [] for key in keys}
    has_residual = False
    for k, (params_k, seg_plan) in enumerate(zip(segs, plan)):
        leaves = _leaves(params_k)
        seg_slots = {key: [None] * len(leaves) for key in keys}
        for bi, bucket in enumerate(seg_plan):
            bst = state["buckets"][k][bi]
            b_leaves = [leaves[i] for i in bucket.leaf_idx]
            for src, dst in _SHARDS:
                flat = _global_flat(bst[src], bucket.padded, world,
                                    f"buckets[{k}][{bi}].{src}")
                for i, piece in zip(bucket.leaf_idx, _leaf_arrays_from_flat(
                        flat[:bucket.n], b_leaves)):
                    seg_slots[dst][i] = piece
            if bst.get("grad_residual") is not None:
                has_residual = True
                res = _consolidated_residual(bst["grad_residual"],
                                             bucket.padded, world)
                for i, piece in zip(bucket.leaf_idx, _leaf_arrays_from_flat(
                        res[:bucket.n], b_leaves)):
                    seg_slots["grad_residual"][i] = piece
        for key in keys:
            slots[key].extend(seg_slots[key])
    full = _header(optimizer, world, _flat_size(params), block_size,
                   grad_compress, param_compress, state["step"])
    for key in keys[:3] + (("grad_residual",) if has_residual else ()):
        full[key] = np.concatenate([p.reshape(-1) for p in slots[key]])
    return full


def reshard_zero_overlap_state(full, params, *, world, grad_compress=None,
                               param_compress=None,
                               block_size=compression.BLOCK_SIZE,
                               message_size=10000000, device=None):
    """Host-side inverse: one full format-1 state_dict (written by either
    step mode, at any world) -> the ``overlap=True`` bucket-partitioned
    state for a ``world``-way group, every bucket re-padded; each
    bucket's ``*_shard`` the ``(padded,)`` concatenation and its residual
    the ``(world, padded)`` stack with rank 0 carrying the whole
    correction."""
    segs, _ = _as_segments(params)
    plan = plan_zero_overlap(segs, world=world, grad_compress=grad_compress,
                             param_compress=param_compress,
                             block_size=block_size,
                             message_size=message_size)
    n = _flat_size(params)
    _check_n(full, n)
    stateful = compression.needs_residual(grad_compress)
    written = full.get("grad_residual")
    if written is not None and not stateful:
        _warn_dropped("reshard_zero_overlap_state")
    flats = {}
    for _, key in _SHARDS:
        v = np.asarray(_np(full[key]), np.float32)
        if v.shape != (n,):
            raise ValueError(f"full state buffer {key} has shape "
                             f"{v.shape}, wanted ({n},)")
        flats[key] = v
    if stateful:
        flats["grad_residual"] = (np.asarray(_np(written), np.float32)
                                  if written is not None
                                  else np.zeros((n,), np.float32))
    buckets, off = [], 0
    for params_k, seg_plan in zip(segs, plan):
        sizes = [leaf.numel() for leaf in _leaves(params_k)]
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

        def gather(key, bucket, off=off, starts=starts):
            return np.concatenate(
                [flats[key][off + starts[i]:off + starts[i + 1]]
                 for i in bucket.leaf_idx])

        seg_states = []
        for bucket in seg_plan:
            bst = {src: _tensor(np.pad(gather(key, bucket),
                                       (0, bucket.padded - bucket.n)),
                                device)
                   for src, key in _SHARDS}
            if stateful:
                rows = np.zeros((world, bucket.padded), np.float32)
                rows[0, :bucket.n] = gather("grad_residual", bucket)
                bst["grad_residual"] = _tensor(rows, device)
            seg_states.append(bst)
        buckets.append(tuple(seg_states))
        off += int(sum(sizes))
    return {"step": torch.from_numpy(
                _np(full["step"]).astype(np.int32).reshape(())),
            "buckets": tuple(buckets)}


# ---------------------------------------------------------------------------
# 2-D (data, model) topologies
# ---------------------------------------------------------------------------

def _dims_like(tree, dims):
    """``dims``'s entries in the leaf order of ``tree`` (``None`` entries
    kept: replicated leaves)."""
    if isinstance(tree, torch.Tensor):
        return [dims]
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _dims_like(tree[k], dims[k])]
    if isinstance(tree, (list, tuple)):
        return [d for t, s in zip(tree, dims) for d in _dims_like(t, s)]
    raise TypeError(f"expected a tensor, dict or list of tensors, got "
                    f"{type(tree).__name__}")


def _partition_dim_leaves(params, partition_dims):
    leaves = _leaves(params)
    dims = _dims_like(params, partition_dims)
    for leaf, dim in zip(leaves, dims):
        if dim is not None and not (
                isinstance(dim, int) and 0 <= dim < leaf.dim()):
            raise ValueError(
                f"partition dim {dim!r} invalid for a leaf of shape "
                f"{tuple(leaf.shape)}")
    return leaves, dims


def split_params_for_model_axis(params, partition_dims, tp_world):
    """FULL param tree -> list (len ``tp_world``) of per-model-rank LOCAL
    trees (CPU tensors), each leaf sliced along its partition dim,
    replicated leaves shared."""
    leaves, dims = _partition_dim_leaves(params, partition_dims)
    per_rank = []
    for t in range(tp_world):
        local = []
        for leaf, dim in zip(leaves, dims):
            a = leaf.detach().cpu()
            if dim is None:
                local.append(a)
                continue
            if a.shape[dim] % tp_world:
                raise ValueError(
                    f"leaf dim {dim} of shape {tuple(a.shape)} does not "
                    f"split {tp_world} ways over the model axis")
            local.append(torch.chunk(a, tp_world, dim=dim)[t].contiguous())
        per_rank.append(_rebuild(params, local))
    return per_rank


def consolidate_zero_state_2d(states, params, partition_dims, *,
                              dp_world, tp_world, grad_compress=None,
                              param_compress=None,
                              block_size=compression.BLOCK_SIZE,
                              message_size=10000000, optimizer="zero"):
    """Host-side: per-``(data, model)``-coordinate ZeRO states -> one full
    format-2 state_dict in the FULL (TP-unsharded) parameter domain.
    ``states`` is a list (model-rank order) of per-model-rank host-global
    1-D states (monolithic or bucketed); split leaves concatenate along
    their partition dim, replicated leaves must be bit-identical across
    model ranks (else it raises)."""
    if len(states) != tp_world:
        raise ValueError(f"got {len(states)} per-model-rank states for "
                         f"tp_world={tp_world}")
    local_params = split_params_for_model_axis(params, partition_dims,
                                               tp_world)
    fulls = []
    kw = dict(world=dp_world, grad_compress=grad_compress,
              param_compress=param_compress, block_size=block_size,
              optimizer=optimizer)
    for t, st in enumerate(states):
        if isinstance(st, dict) and "buckets" in st:
            fulls.append(consolidate_zero_overlap_state(
                st, local_params[t], message_size=message_size, **kw))
        else:
            fulls.append(consolidate_zero_state(st, local_params[t], **kw))
    steps = {int(f["step"]) for f in fulls}
    if len(steps) != 1:
        raise ValueError(f"model ranks disagree on the step: {steps} — "
                         "states from different checkpoints?")
    leaves, dims = _partition_dim_leaves(params, partition_dims)
    full = {"format": 2, "optimizer": optimizer, "dp_world": int(dp_world),
            "tp_world": int(tp_world), "n_elements": _flat_size(params),
            "block_size": int(block_size), "grad_compress": grad_compress,
            "param_compress": param_compress, "step": fulls[0]["step"]}
    keys = ["master", "exp_avg", "exp_avg_sq"]
    if all("grad_residual" in f for f in fulls):
        keys.append("grad_residual")
    for key in keys:
        per_rank = [_leaf_arrays_from_flat(
            np.asarray(fulls[t][key], np.float32), _leaves(local_params[t]))
            for t in range(tp_world)]
        merged = []
        for li, dim in enumerate(dims):
            pieces = [per_rank[t][li] for t in range(tp_world)]
            if dim is None:
                for t in range(1, tp_world):
                    if not np.array_equal(pieces[0], pieces[t]):
                        raise ValueError(
                            f"{key}: replicated leaf {li} differs between "
                            f"model ranks 0 and {t} — the 2-D program's "
                            f"model-invariance broke; refusing to "
                            f"consolidate")
                merged.append(pieces[0])
            else:
                merged.append(np.concatenate(pieces, axis=dim))
        full[key] = np.concatenate([p.reshape(-1) for p in merged])
    return full


def reshard_zero_state_2d(full, params, partition_dims, *, dp_world,
                          tp_world, grad_compress=None, param_compress=None,
                          block_size=compression.BLOCK_SIZE,
                          message_size=10000000, overlap=False, device=None):
    """Host-side inverse of :func:`consolidate_zero_state_2d`: one full
    format-1/2 state_dict -> the list (len ``tp_world``) of per-model-rank
    1-D states for a NEW ``(dp_world, tp_world)`` topology, monolithic or
    bucketed (``overlap``); TP slicing and dp-shard padding
    recomputed."""
    if full.get("format") not in (1, 2):
        raise ValueError(f"unknown state_dict format {full.get('format')!r}")
    _check_n(full, _flat_size(params))
    leaves, dims = _partition_dim_leaves(params, partition_dims)
    local_params = split_params_for_model_axis(params, partition_dims,
                                               tp_world)
    keys = ["master", "exp_avg", "exp_avg_sq"]
    if full.get("grad_residual") is not None:
        keys.append("grad_residual")
    states = []
    kw = dict(world=dp_world, grad_compress=grad_compress,
              param_compress=param_compress, block_size=block_size,
              device=device)
    for t in range(tp_world):
        sub = {"format": 1, "optimizer": full.get("optimizer"),
               "n_elements": _flat_size(local_params[t]),
               "step": full["step"]}
        for key in keys:
            full_leaves = _leaf_arrays_from_flat(
                np.asarray(_np(full[key]), np.float32), leaves)
            local = [a if dim is None else np.split(a, tp_world, axis=dim)[t]
                     for a, dim in zip(full_leaves, dims)]
            sub[key] = np.concatenate([p.reshape(-1) for p in local])
        if overlap:
            states.append(reshard_zero_overlap_state(
                sub, local_params[t], message_size=message_size, **kw))
        else:
            states.append(reshard_zero_state(sub, local_params[t], **kw))
    return states


def split_params_for_pipe_axis(*args, **kwargs):
    _refuse_pipe("split_params_for_pipe_axis")


def consolidate_zero_state_3d(*args, **kwargs):
    _refuse_pipe("consolidate_zero_state_3d")


def reshard_zero_state_3d(*args, **kwargs):
    _refuse_pipe("reshard_zero_state_3d")


def zero_state_bytes(params, *, world, grad_compress=None,
                     param_compress=None, block_size=compression.BLOCK_SIZE,
                     axis_name="dp", optimizer="zero", registry=None,
                     record=True):
    """Sharded vs unsharded optimizer-state bytes per rank at ``world``-way
    ZeRO sharding: ``unsharded_state_bytes`` is a replicated fp32
    Adam/LAMB's three buffers of the padded length, ``sharded_state_bytes``
    this optimizer's (the three at 1/world, plus the full-length residual
    of int8/int4 gradients, which is not sharded). JAX's report dict;
    with ``record`` and the registry (``registry``, else the process's)
    enabled it also lands the ``memory/zero_state_sharded_bytes`` and
    ``memory/zero_state_unsharded_bytes`` gauges and a ``memory``
    event."""
    n = _flat_size(params)
    padded = _padded_size(n, world, grad_compress, param_compress,
                          block_size)
    f32 = 4
    unsharded = 3 * padded * f32
    sharded = 3 * (padded // world) * f32
    residual = padded * f32 if compression.needs_residual(grad_compress) else 0
    params_bytes = int(sum(leaf.numel() * leaf.element_size()
                           for leaf in _leaves(params)))
    report = {
        "optimizer": optimizer,
        "axis_name": str(axis_name),
        "world": int(world),
        "n_elements": n,
        "padded_elements": padded,
        "params_bytes": params_bytes,
        "unsharded_state_bytes": unsharded,
        "sharded_state_bytes": sharded + residual,
        "residual_bytes": residual,
        "savings_bytes": unsharded - (sharded + residual),
        "savings_ratio": unsharded / max(sharded + residual, 1),
        "grad_compress": grad_compress,
        "param_compress": param_compress,
    }
    if record:
        reg = registry or get_registry()
        if reg.enabled:
            reg.gauge("memory/zero_state_sharded_bytes").set(
                report["sharded_state_bytes"])
            reg.gauge("memory/zero_state_unsharded_bytes").set(unsharded)
            reg.event("memory", "zero_state_bytes", **report)
    return report


class ZeroBucket(NamedTuple):
    """One planned ZeRO overlap bucket: segment-local leaf indices, the
    flat element count, and the world/block-aligned padded length its
    shards are cut from."""

    leaf_idx: tuple
    n: int
    padded: int


def plan_zero_overlap(segment_params, *, world, grad_compress=None,
                      param_compress=None, block_size=compression.BLOCK_SIZE,
                      message_size=10000000):
    """Host-side overlap bucket plan: per segment (a list of param trees;
    ``[params]`` for an unsegmented model), the dtype-segregated
    ``message_size``-capped grouping of ``plan_buckets``, each bucket
    padded for ``world``-way sharding. Buckets never span segments."""
    plan = []
    for params in segment_params:
        leaves = _leaves(params)
        buckets = []
        if leaves:
            for idxs in plan_buckets(leaves, message_size):
                n = int(sum(leaves[i].numel() for i in idxs))
                buckets.append(ZeroBucket(
                    tuple(idxs), n, _padded_size(n, world, grad_compress,
                                                 param_compress,
                                                 block_size)))
        plan.append(tuple(buckets))
    return tuple(plan)


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

class _Zero:
    """What DistributedFusedAdam and DistributedFusedLAMB share: the flat
    and bucketed layouts, the collectives, the byte report and the
    elastic state. The subclasses bring the update."""

    def _setup(self, axis_name, compress, grad_compress, param_compress,
               compress_block_size, numerics, overlap, message_size):
        self.axis_name = axis_name
        # compress=True: int8 gradients with error feedback (the residual
        # in the state) and a bf16 parameter gather; either overridable
        if compress and grad_compress is None:
            grad_compress = "int8"
        if compress and param_compress is None:
            param_compress = "bf16"
        self.grad_compress = grad_compress
        self.param_compress = param_compress
        self.compress_block_size = compress_block_size
        self.numerics = numerics
        self.overlap = overlap
        self.message_size = message_size

    def _world(self):
        return groups.axis_size(self.axis_name)

    def _padded(self, n, world):
        return _padded_size(n, world, self.grad_compress,
                            self.param_compress, self.compress_block_size)

    def _shard_of(self, flat, world):
        """This rank's slice of a padded flat vector (the vector itself at
        world 1)."""
        if world == 1:
            return flat
        per = flat.shape[0] // world
        rank = groups.axis_rank(self.axis_name)
        return flat[rank * per:(rank + 1) * per].clone()

    def _new_state(self, leaves, padded, world):
        shard = self._shard_of(_flatten_f32(leaves, padded), world)
        state = {"master_shard": shard,
                 "exp_avg_shard": torch.zeros_like(shard),
                 "exp_avg_sq_shard": torch.zeros_like(shard)}
        if compression.needs_residual(self.grad_compress):
            state["grad_residual"] = torch.zeros(
                padded, dtype=torch.float32, device=shard.device)
        return state

    def _reduce_scatter(self, flat_g, residual, world):
        """The flat gradient reduce-scattered over the axis, optionally
        through a compressed payload: (this rank's summed shard, new
        residual or None). World 1 skips it, as JAX's."""
        if world == 1:
            return flat_g, residual
        group = groups.axis_group(self.axis_name)
        with record_function("zero/grad_reduce_scatter"):
            if self.grad_compress is None:
                shard = torch.empty(flat_g.shape[0] // world,
                                    dtype=flat_g.dtype, device=flat_g.device)
                compression._reduce_scatter(shard, flat_g, group)
                return shard, None
            return compression.psum_scatter_compressed(
                flat_g, self.axis_name, mode=self.grad_compress,
                residual=residual, block_size=self.compress_block_size)

    def _gather_params(self, p_new, world):
        if world == 1:
            return p_new
        group = groups.axis_group(self.axis_name)
        with record_function("zero/param_all_gather"):
            if self.param_compress is None:
                return compression._all_gather(p_new, group)
            return compression.all_gather_compressed(
                p_new, self.axis_name, mode=self.param_compress,
                block_size=self.compress_block_size)

    def _finish(self, state, new_state, residual, skip):
        """The residual of a step: an overflow-skipped step consumed a
        bogus gradient, so its quantization error is dropped."""
        if compression.needs_residual(self.grad_compress):
            new_state["grad_residual"] = (state["grad_residual"] if skip
                                          else residual)
        return new_state

    # -- the overlapped (bucketed) layout --------------------------------

    def overlap_plan(self, params_or_segments):
        segs, _ = _as_segments(params_or_segments)
        return plan_zero_overlap(
            segs, world=self._world(), grad_compress=self.grad_compress,
            param_compress=self.param_compress,
            block_size=self.compress_block_size,
            message_size=self.message_size)

    def _init_overlapped(self, params):
        segs, _ = _as_segments(params)
        world = self._world()
        buckets = []
        for params_k, seg_plan in zip(segs, self.overlap_plan(segs)):
            leaves = _leaves(params_k)
            buckets.append(tuple(
                self._new_state([leaves[i] for i in b.leaf_idx], b.padded,
                                world)
                for b in seg_plan))
        return {"step": _step_tensor(0), "buckets": tuple(buckets)}

    def init(self, params):
        """State: the local fp32 master/moment shards of the padded flat
        vector (+ the full-length error-feedback residual with int8/int4
        gradients) and ``step`` 0. With ``overlap=True`` the state is
        bucket-partitioned (``{"step", "buckets": ...}``) and ``params``
        may be a list of per-segment trees."""
        if self.overlap:
            return self._init_overlapped(params)
        leaves = _leaves(params)
        world = self._world()
        state = self._new_state(leaves, self._padded(_flat_size(params),
                                                     world), world)
        return {"step": _step_tensor(0), **state}

    def bucket_reduce(self, flat_g, bstate):
        """Reduce-scatter ONE bucket's padded flat gradient: (the local
        shard, averaged, new residual or None)."""
        world = self._world()
        g_shard, residual = self._reduce_scatter(
            flat_g, bstate.get("grad_residual"), world)
        return self._average(g_shard, world), residual

    def _grad_stats(self, grads):
        """The ``numerics=`` statistics of the local gradients (None when
        the knob is off)."""
        if not self.numerics:
            return None
        return _numerics.tree_stats(
            grads, prefix_depth=_numerics_depth(self.numerics),
            prefix="grads")

    def _step_overlapped(self, grads, state, params, *, lr, found_inf,
                         scale):
        g_segs, was_list = _as_segments(grads)
        p_segs, _ = _as_segments(params)
        stats = None
        if self.numerics:
            stats = _numerics.merge(*[self._grad_stats(g) for g in g_segs])
        walk = _BucketStep(self, state, p_segs, lr=lr, found_inf=found_inf)
        for k, grads_k in enumerate(g_segs):
            walk.reduce(k, _leaves(grads_k), scale)
        new_params, new_state = walk.finish()
        out = (new_params if was_list else new_params[0]), new_state
        return out if stats is None else out + (stats,)

    # -- accounting and the elastic state ---------------------------------

    def state_bytes(self, params, *, world=None, registry=None, record=True):
        """Per-rank sharded vs unsharded optimizer-state bytes for
        ``params`` at ``world``-way sharding (default: the axis's world).
        See :func:`zero_state_bytes`."""
        return zero_state_bytes(
            params, world=self._world() if world is None else world,
            grad_compress=self.grad_compress,
            param_compress=self.param_compress,
            block_size=self.compress_block_size, axis_name=self.axis_name,
            optimizer=type(self).__name__, registry=registry, record=record)

    def topology(self, world):
        """The writing-topology record a checkpoint keeps beside the state:
        what :meth:`load_state_dict_resharded` needs. ``world`` is the dp
        replica count, or a ``(dp, tp)`` pair for a 2-D mesh."""
        if isinstance(world, (tuple, list)):
            world = [int(w) for w in world]
        else:
            world = int(world)
        return {"optimizer": type(self).__name__, "world": world,
                "axis_name": str(self.axis_name),
                "grad_compress": self.grad_compress,
                "param_compress": self.param_compress,
                "block_size": int(self.compress_block_size)}

    def state_dict_full(self, state, params, *, world, partition_dims=None):
        """Host-side: the run's ZeRO state -> one full unpadded
        state_dict (numpy arrays) that :meth:`load_state_dict_resharded`
        re-partitions onto any topology. ``world`` an int: the monolithic
        or the bucketed (``"buckets"`` key) layout; a ``(dp, tp)`` pair:
        ``state`` is the list of per-model-rank states and
        ``partition_dims`` each leaf's model-axis split dim."""
        kw = dict(grad_compress=self.grad_compress,
                  param_compress=self.param_compress,
                  block_size=self.compress_block_size,
                  optimizer=type(self).__name__)
        if isinstance(world, (tuple, list)):
            if len(world) == 3:
                _refuse_pipe("state_dict_full")
            if partition_dims is None:
                raise ValueError("state_dict_full: a 2-D world needs "
                                 "partition_dims (the per-leaf model-axis "
                                 "split table)")
            dp, tp = world
            return consolidate_zero_state_2d(
                state, params, partition_dims, dp_world=dp, tp_world=tp,
                message_size=self.message_size, **kw)
        if isinstance(state, dict) and "buckets" in state:
            return consolidate_zero_overlap_state(
                state, params, world=world, message_size=self.message_size,
                **kw)
        return consolidate_zero_state(state, params, world=world, **kw)

    def load_state_dict_resharded(self, full, params, *, world,
                                  partition_dims=None, device=None):
        """Host-side: a :meth:`state_dict_full` dict (written at any
        topology, by either step mode, by this package or JAX's) -> this
        optimizer's state for the target topology (bucketed iff
        ``overlap``), shard padding recomputed; masters, moments and the
        residual restore bit-exactly. Tensors on ``device`` (default the
        CPU; ``step`` stays a CPU tensor). ``world`` a ``(dp, tp)`` pair
        restores the list of per-model-rank states."""
        kw = dict(grad_compress=self.grad_compress,
                  param_compress=self.param_compress,
                  block_size=self.compress_block_size, device=device)
        if isinstance(world, (tuple, list)):
            if len(world) == 3:
                _refuse_pipe("load_state_dict_resharded")
            if partition_dims is None:
                raise ValueError("load_state_dict_resharded: a 2-D world "
                                 "needs partition_dims (the per-leaf "
                                 "model-axis split table)")
            dp, tp = world
            return reshard_zero_state_2d(
                full, params, partition_dims, dp_world=dp, tp_world=tp,
                message_size=self.message_size, overlap=bool(self.overlap),
                **kw)
        if self.overlap:
            return reshard_zero_overlap_state(
                full, params, world=world, message_size=self.message_size,
                **kw)
        return reshard_zero_state(full, params, world=world, **kw)


class _BucketStep:
    """One ``overlap=True`` step, bucket by bucket: :meth:`reduce` takes a
    segment's gradients (its buckets' reduce-scatters, and their updates
    and gathers unless the update needs the global gradient norm first),
    :meth:`finish` runs the deferred updates and returns ``(new segment
    params, new state)``. The optimizer's ``step`` and
    ``parallel.overlap.overlapped_zero_step`` both walk it."""

    def __init__(self, opt, state, segment_params, *, lr, found_inf):
        device = next((b["master_shard"].device for seg in state["buckets"]
                       for b in seg), None)
        self.opt, self.state, self.lr = opt, state, lr
        self.segs = list(segment_params)
        self.plan = opt.overlap_plan(self.segs)
        self.noop, self.skip = _noop(found_inf, device)
        self.step = _next_step(state, self.skip)
        self.leaves = [list(_leaves(p)) for p in self.segs]
        self.buckets = [list(seg) for seg in state["buckets"]]
        self.deferred = []

    def reduce(self, k, g_leaves, scale=1.0, numbered=None):
        """Segment k's buckets from its gradient leaves; ``numbered(bi)``,
        if given, is a context manager opened around bucket bi."""
        for bi, bucket in enumerate(self.plan[k]):
            with numbered(bi) if numbered else contextlib.nullcontext():
                flat_g = _flatten_f32([g_leaves[i] for i in bucket.leaf_idx],
                                      bucket.padded, scale)
                g_shard, residual = self.opt.bucket_reduce(
                    flat_g, self.state["buckets"][k][bi])
                if self.opt.overlap_needs_global_norm:
                    self.deferred.append((k, bi, g_shard, residual))
                else:
                    self._update(k, bi, g_shard, residual, None)

    def _update(self, k, bi, g_shard, residual, clip):
        bucket, leaves = self.plan[k][bi], self.leaves[k]
        out, self.buckets[k][bi] = self.opt.bucket_update_gather(
            g_shard, self.state["buckets"][k][bi], bucket,
            [leaves[i] for i in bucket.leaf_idx], lr=self.lr, step=self.step,
            noop=self.noop, skip=self.skip, clip=clip, new_residual=residual)
        for i, leaf in zip(bucket.leaf_idx, out):
            leaves[i] = leaf

    def finish(self):
        if self.deferred:
            clip = self.opt.overlap_global_clip([d[2] for d in self.deferred])
            for k, bi, g_shard, residual in self.deferred:
                self._update(k, bi, g_shard, residual, clip)
        new_params = [_rebuild(p, leaves)
                      for p, leaves in zip(self.segs, self.leaves)]
        return new_params, {"step": _step_tensor(self.step),
                            "buckets": tuple(tuple(s) for s in self.buckets)}


class DistributedFusedAdam(_Zero):
    """ZeRO Adam/AdamW (``adam_w_mode``) with the reference's core
    arguments; the process group is the axis's (``axis_name``). See the
    module docstring for the state, the interface and world 1."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0,
                 axis_name="dp", grad_sync_dtype=None, store_params=False,
                 store_param_remainders=False, compress: bool = False,
                 grad_compress: Optional[str] = None,
                 param_compress: Optional[str] = None,
                 compress_block_size: int = compression.BLOCK_SIZE,
                 numerics=None, overlap: bool = False,
                 message_size: int = 10000000):
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.grad_sync_dtype = grad_sync_dtype
        self._setup(axis_name, compress, grad_compress, param_compress,
                    compress_block_size, numerics, overlap, message_size)

    @property
    def overlap_needs_global_norm(self):
        """Adam has no cross-bucket coupling."""
        return False

    def _average(self, g_shard, world):
        return g_shard if world == 1 else _div(g_shard, world)

    def _adam(self, noop, g_shard, st, step, lr):
        """One launch of #12 on a local shard, in place."""
        b1, b2 = self.betas
        bc1, bc2 = (bias_corrections(b1, b2, step) if self.bias_correction
                    else (1.0, 1.0))
        _koptim.adam(noop, [g_shard], [st["master_shard"]],
                     [st["exp_avg_shard"]], [st["exp_avg_sq_shard"]],
                     lr=self.lr if lr is None else lr, bc1=bc1,
                     bc2=bc2, b1=b1, b2=b2, eps=self.eps,
                     weight_decay=self.weight_decay,
                     adam_w=bool(self.adam_w_mode))

    def bucket_update_gather(self, g_shard, bstate, bucket, p_leaves, *,
                             lr=None, step, noop, skip=False, clip=None,
                             new_residual=None):
        """The sharded Adam update (one #12 launch) and the param gather
        for ONE bucket: (new param leaves, new bucket state). ``step`` is
        the step count after this update (host int), ``noop`` the
        kernel's flag, ``skip`` its host value."""
        if clip is not None:
            raise ValueError("DistributedFusedAdam has no global-norm "
                             "clip; clip must be None")
        self._adam(noop, g_shard, bstate, step, lr)
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
        noop, skip = _noop(found_inf, state["master_shard"].device)
        flat_g = _flatten_f32(g_leaves, self._padded(n, world), scale)
        g_shard, residual = self._reduce_scatter(
            flat_g, state.get("grad_residual"), world)
        g_shard = self._average(g_shard, world)
        step = _next_step(state, skip)
        self._adam(noop, g_shard, state, step, lr)
        flat_p = self._gather_params(state["master_shard"], world)
        new_state = self._finish(state, {**state, "step": _step_tensor(step)},
                                 residual, skip)
        out = _rebuild(params, _unflatten_like(flat_p[:n], leaves)), new_state
        return out if stats is None else out + (stats,)
