"""The 2-D ``(data, model)`` mesh: tensor parallelism inside, compressed
data parallelism across.

Counterpart of ``apex_tpu/parallel/mesh2d.py``: a GPT-2-shaped
transformer written with column- and row-parallel shards over the
``model`` axis, trained with :class:`~apex_tpu_torch.parallel.
OverlappedDataParallel` (or ``DistributedDataParallel``) over the
``data`` axis. The TP collectives move
activations and stay fp32 (the ``copy_to`` backward all-reduce of dx,
the ``reduce_from`` forward all-reduce of the row-parallel partials);
the DP sync moves gradients and compresses them (int8 by default, with
an error-feedback residual per ``(data, model)`` coordinate).

:func:`mesh_2d` lays the ranks of the default process group out row
major, ``np.arange(world).reshape(data, model)`` (rank r is JAX's device
r), makes a process group for each row (``model``) and each column
(``data``), every rank making every group in the same order, and binds
the two axis names in :mod:`apex_tpu_torch.parallel.groups`. Where JAX
places full arrays with ``NamedSharding`` and lets ``shard_map`` hand
each device its shard, here :func:`shard_params` gives each rank its
local shards, and the step runs on them.

With ``fused=True`` the row-parallel projections run through
:func:`apex_tpu_torch.kernels.fused_cc.matmul_reduce_from`: the GEMM in
four column tiles on kernel #20, each tile all-reduced when it is done;
the same wire elements and gradients as the unfused composition.

``mode="overlapped"`` (the default, as JAX's) runs the segmented backward
of :class:`~apex_tpu_torch.parallel.overlap.OverlappedDataParallel` over
:func:`gpt2_segments`, each bucket's DP sync issued as its layer's
backward finishes, the int8 residual in the bucket domain;
``mode="baseline"`` runs the full backward, then the bucketed sync, then
SGD; ``mode="guarded"`` runs the overlapped step under
``resilience.guarded_update``.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.kernels import fused_cc
from apex_tpu_torch.parallel import compression
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    _leaves,
    _rebuild,
)
from apex_tpu_torch.parallel.groups import register_axis
from apex_tpu_torch.parallel.overlap import OverlappedDataParallel
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region as _copy_to,
    reduce_from_tensor_model_parallel_region as _reduce_from,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"

# column-parallel weights split their output dim and their biases ride
# along; row-parallel weights split their input dim and their bias is
# added after the all-reduce (replicated). Everything else replicates.
_COL_W = frozenset({"wq", "wk", "wv", "wi"})
_COL_B = frozenset({"bq", "bk", "bv", "bi"})
_ROW_W = frozenset({"wo"})


@dataclass
class Mesh2D:
    """This rank's view of the mesh: the axis sizes, its coordinates and
    the process groups of its row (``model``) and column (``data``)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def mesh_2d(data=2, model=None):
    """The ``(data, model)`` mesh over every rank of the default process
    group: ``data`` rows of ``model`` ranks (default ``model = world //
    data``). Every rank must call it."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "mesh_2d: no torch.distributed process group is initialized; "
            "call apex_tpu_torch.parallel.multiproc.initialize_distributed()"
            " first")
    world = dist.get_world_size()
    if model is None:
        if world % data:
            raise ValueError(f"mesh_2d: {world} ranks do not split into "
                             f"data={data} rows")
        model = world // data
    if data * model != world:
        raise ValueError(f"mesh_2d: the mesh takes every rank: data={data} "
                         f"x model={model} is not the world of {world}")
    grid = np.arange(world).reshape(data, model)
    rank = dist.get_rank()

    def group(ranks):  # a group of every rank is the default group
        return (dist.group.WORLD if len(ranks) == world
                else dist.new_group(ranks))

    rows = [group(grid[d, :].tolist()) for d in range(data)]
    cols = [group(grid[:, m].tolist()) for m in range(model)]
    d, m = divmod(rank, model)
    mesh = Mesh2D(data, model, d, m, cols[m], rows[d])
    register_axis(DATA_AXIS, mesh.data_group)
    register_axis(MODEL_AXIS, mesh.model_group)
    return mesh


# ---------------------------------------------------------------------------
# GPT-2 params: a stack of pre-LN transformer blocks, segment-shaped
# ---------------------------------------------------------------------------

def gpt2_init(hidden=64, layers=2, heads=4, vocab=64, max_seq=32, *,
              bias=True, seed=0, device=None):
    """FULL (unsharded) GPT-2-style params as a tuple of per-layer segment
    dicts: segment 0 carries the (replicated) embedding tables, the last
    segment the final layer norm and the untied LM head. fp32, drawn from
    ``np.random.RandomState(seed)`` in JAX's order, so they equal JAX's
    bit for bit; on the card unless ``device`` says otherwise."""
    if hidden % heads:
        raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
    device = resolve_device(device)
    rng = np.random.RandomState(seed)

    def w(*shape, scale=None):
        # the product is float64, rounded to fp32 as jnp.asarray rounds it
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        a = (rng.randn(*shape).astype(np.float32) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def layer():
        p = {
            "ln1": {"g": ones(hidden), "b": zeros(hidden)},
            "attn": {"wq": w(hidden, hidden), "wk": w(hidden, hidden),
                     "wv": w(hidden, hidden), "wo": w(hidden, hidden)},
            "ln2": {"g": ones(hidden), "b": zeros(hidden)},
            "mlp": {"wi": w(hidden, 4 * hidden), "wo": w(4 * hidden, hidden)},
        }
        if bias:
            for name in ("bq", "bk", "bv", "bo"):
                p["attn"][name] = zeros(hidden)
            p["mlp"]["bi"] = zeros(4 * hidden)
            p["mlp"]["bo"] = zeros(hidden)
        return p

    segments = []
    for i in range(layers):
        seg = {"layer": layer()}
        if i == 0:
            seg["embed"] = {"wte": w(vocab, hidden, scale=0.02),
                            "wpe": w(max_seq, hidden, scale=0.02)}
        if i == layers - 1:
            seg["ln_f"] = {"g": ones(hidden), "b": zeros(hidden)}
            seg["head"] = {"w": w(hidden, vocab)}
        segments.append(seg)
    return tuple(segments)


def _map(fn, tree, *rest):
    """``fn(name, leaf, *other leaves)`` over nested dicts and tuples,
    ``name`` the leaf's own key."""
    if isinstance(tree, dict):
        return {k: (_map(fn, v, *(r[k] for r in rest))
                    if isinstance(v, (dict, tuple, list))
                    else fn(k, v, *(r[k] for r in rest)))
                for k, v in tree.items()}
    return tuple(_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree))


def _dim(name):
    if name in _COL_W:
        return 1
    if name in _COL_B or name in _ROW_W:
        return 0
    return None


def gpt2_partition_dims(seg_params):
    """The tree of ``seg_params`` holding the dim each leaf splits over the
    ``model`` axis (``None`` for replicated leaves)."""
    return _map(lambda name, leaf: _dim(name), seg_params)


def _local_shape(name, leaf, tp):
    dim = _dim(name)
    shape = list(leaf.shape)
    if dim is not None:
        if shape[dim] % tp:
            raise ValueError(
                f"leaf dim {dim} of shape {tuple(leaf.shape)} does not split "
                f"{tp} ways over '{MODEL_AXIS}'")
        shape[dim] //= tp
    return dim, shape


def local_template(seg_params, tp):
    """Zeros shaped like each leaf's LOCAL (per-model-rank) shard: what
    ``init_residual`` sizes the DP error-feedback state from."""
    return _map(lambda name, leaf: leaf.new_zeros(_local_shape(name, leaf,
                                                               tp)[1]),
                seg_params)


def shard_params(seg_params, tp_rank, tp):
    """This rank's shards of the full ``seg_params``: split leaves narrowed
    to slice ``tp_rank`` of ``tp`` along their partition dim, replicated
    leaves copied."""
    def shard(name, leaf):
        dim, shape = _local_shape(name, leaf, tp)
        if dim is None:
            return leaf.clone()
        return leaf.narrow(dim, tp_rank * shape[dim], shape[dim]).clone()

    return _map(shard, seg_params)


# ---------------------------------------------------------------------------
# the forward math (on LOCAL shards)
# ---------------------------------------------------------------------------

def _ln(p, x, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def _row_parallel(x, w, fused):
    if fused:
        return fused_cc.matmul_reduce_from(x, w, MODEL_AXIS)
    return _reduce_from(x @ w, MODEL_AXIS)


def _attn(p, x, head_dim, fused=False):
    """Column-parallel QKV (this rank's heads) -> causal attention ->
    row-parallel output projection joined by one TP all-reduce (in tiles
    on kernel #20 with ``fused``)."""
    xp = _copy_to(x, MODEL_AXIS)       # identity fwd / all-reduce(dx) bwd
    q = xp @ p["wq"] + p.get("bq", 0.0)
    k = xp @ p["wk"] + p.get("bk", 0.0)
    v = xp @ p["wv"] + p.get("bv", 0.0)
    b, s, local = q.shape
    nh = local // head_dim
    q = q.reshape(b, s, nh, head_dim)
    k = k.reshape(b, s, nh, head_dim)
    v = v.reshape(b, s, nh, head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(head_dim)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = torch.where(causal, scores, -1e9)
    ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                       v).reshape(b, s, local)
    return _row_parallel(ctx, p["wo"], fused) + p.get("bo", 0.0)


def _mlp(p, x, fused=False):
    xp = _copy_to(x, MODEL_AXIS)
    h = F.gelu(xp @ p["wi"] + p.get("bi", 0.0), approximate="tanh")
    return _row_parallel(h, p["wo"], fused) + p.get("bo", 0.0)


def _block(p, x, head_dim, fused=False):
    x = x + _attn(p["attn"], _ln(p["ln1"], x), head_dim, fused=fused)
    return x + _mlp(p["mlp"], _ln(p["ln2"], x), fused=fused)


def _xent(logits, labels):
    ls = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(ls, -1, labels.long()[..., None])
    return -torch.mean(picked)


def gpt2_segments(labels, layers, head_dim, *, poison=None, fused=False):
    """The per-layer segment chain ``segments[k](params_k, carry) ->
    carry``: segment 0 embeds the token batch, the last segment closes
    over ``labels`` and returns the scalar loss. ``poison`` (an additive
    scalar, e.g. ``faults.inject_nan``'s output) enters at the embedding
    output so a NaN reaches every gradient."""

    def seg0(p, tokens):
        emb = p["embed"]
        x = emb["wte"][tokens] + emb["wpe"][:tokens.shape[1]]
        if poison is not None:
            x = x + poison
        return _block(p["layer"], x, head_dim, fused=fused)

    def seg_mid(p, x):
        return _block(p["layer"], x, head_dim, fused=fused)

    def seg_last(p, x):
        if "layer" in p:
            x = _block(p["layer"], x, head_dim, fused=fused)
        x = _ln(p["ln_f"], x)
        return _xent(x @ p["head"]["w"], labels)

    if layers == 1:
        def only(p, tokens):
            x = seg0({"embed": p["embed"], "layer": p["layer"]}, tokens)
            x = _ln(p["ln_f"], x)
            return _xent(x @ p["head"]["w"], labels)

        return [only]
    return [seg0] + [seg_mid] * (layers - 2) + [seg_last]


def gpt2_loss(seg_params, tokens, labels, head_dim, *, fused=False):
    """The whole-model loss: the segment chain run in order."""
    carry = tokens
    for fn, p in zip(gpt2_segments(labels, len(seg_params), head_dim,
                                   fused=fused), seg_params):
        carry = fn(p, carry)
    return carry


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def build_train_step(mesh, seg_params, *, hidden, heads, mode="overlapped",
                     compress="int8", lr=0.05, fold_average=True,
                     message_size=10000000, guard_nan_step=None,
                     fused=False):
    """One 2-D train step on this rank's shards:
    ``step(sp, res, tokens, labels) -> (sp, res, loss)``, where ``loss``
    is this rank's (its data row's batch) and ``sp`` the new shards.

    ``mode="overlapped"`` (default): the segmented backward of
    ``OverlappedDataParallel(axis_name="data", compress=compress,
    fold_average=fold_average)`` over :func:`gpt2_segments`, each bucket's
    DP sync issued as its segment's backward finishes; ``res`` is the
    bucket-domain residual. ``mode="baseline"``: the loss and its
    backward, then ``DistributedDataParallel(axis_name="data",
    compress=compress).sync``; ``res`` leaf-shaped. ``res`` is ``None``
    where ``compress`` keeps no residual. Then SGD ``w - lr * g``.
    ``fused`` routes the row-parallel projections through
    ``matmul_reduce_from``.

    ``mode="guarded"``: the overlapped step under
    ``resilience.guarded_update``, the local non-finite flag (the
    overlap's ``guard_flag``) OR'd over every rank of the mesh with one
    fp32 all-reduce; a skipped step leaves the shards and the residual
    as they were (``torch.where`` on the device, no host sync):
    ``step(sp, res, gst, step_idx, tokens, labels) -> (sp, res, gst,
    loss)``. ``guard_nan_step`` arms ``faults.inject_nan`` at the
    embedding output at that step (``step_idx`` a host int or a device
    int tensor).

    Returns ``(step, state)``, ``state`` the carry ``(shards, residual)``
    (``(shards, residual, guard_state)`` when guarded), the shards on
    ``seg_params``' device."""
    if mode not in ("baseline", "overlapped", "guarded"):
        raise ValueError(f"unknown mode {mode!r}")
    head_dim = hidden // heads
    layers = len(seg_params)
    shards = shard_params(seg_params, mesh.model_rank, mesh.model)
    stateful = compression.needs_residual(compress)

    def sgd(leaves, grads):
        with torch.no_grad():
            return [w - lr * g for w, g in zip(leaves, grads)]

    if mode == "guarded":
        return _guarded_step(shards, layers, head_dim, compress=compress,
                             lr=lr, fold_average=fold_average,
                             message_size=message_size,
                             guard_nan_step=guard_nan_step, fused=fused,
                             sgd=sgd)

    if mode == "overlapped":
        odp = OverlappedDataParallel(axis_name=DATA_AXIS, compress=compress,
                                     fold_average=fold_average,
                                     message_size=message_size)
        residual = odp.init_residual(shards) if stateful else None

        def step(sp, res, tokens, labels):
            segs = gpt2_segments(labels, layers, head_dim, fused=fused)
            if stateful:
                loss, synced, res = odp.value_and_sync(segs, list(sp), tokens,
                                                       residual=res)
            else:
                loss, synced = odp.value_and_sync(segs, list(sp), tokens)
            return (_rebuild(sp, sgd(_leaves(sp), _leaves(synced))), res,
                    loss)

        return step, (shards, residual)

    ddp = DistributedDataParallel(axis_name=DATA_AXIS, compress=compress,
                                  message_size=message_size)
    residual = ddp.init_residual(shards) if stateful else None

    def step(sp, res, tokens, labels):
        leaves = [p.detach().requires_grad_() for p in _leaves(sp)]
        sp = _rebuild(sp, leaves)
        loss = gpt2_loss(sp, tokens, labels, head_dim, fused=fused)
        grads = _rebuild(sp, torch.autograd.grad(loss, leaves))
        if stateful:
            grads, res = ddp.sync(grads, res)
        else:
            grads = ddp.sync(grads)
        return _rebuild(sp, sgd(leaves, _leaves(grads))), res, loss.detach()

    return step, (shards, residual)


def _guarded_step(shards, layers, head_dim, *, compress, lr, fold_average,
                  message_size, guard_nan_step, fused, sgd):
    from apex_tpu_torch import resilience
    from apex_tpu_torch.resilience import faults

    stateful = compression.needs_residual(compress)
    odp = OverlappedDataParallel(axis_name=DATA_AXIS, compress=compress,
                                 fold_average=fold_average,
                                 message_size=message_size, guard_flag=True)
    residual = odp.init_residual(shards) if stateful else None
    leaves0 = _leaves(shards)
    device = leaves0[0].device

    def step(sp, res, gst, step_idx, tokens, labels):
        poison = faults.inject_nan(
            torch.zeros((), dtype=torch.float32, device=device), step_idx,
            nan_step=guard_nan_step)
        segs = gpt2_segments(labels, layers, head_dim,
                             poison=poison if guard_nan_step is not None
                             else None, fused=fused)
        if stateful:
            loss, synced, new_res, flag = odp.value_and_sync(
                segs, list(sp), tokens, residual=res)
        else:
            loss, synced, flag = odp.value_and_sync(segs, list(sp), tokens)
            new_res = None

        def commit(g, st, _flag):
            prev_sp, _ = st
            return (_rebuild(prev_sp, sgd(_leaves(prev_sp), _leaves(g))),
                    new_res)

        # every rank of the mesh is in the default group: the OR spans
        # both axes, as JAX's psum over (data, model)
        (sp, res), gst = resilience.guarded_update(
            synced, commit, (sp, res), gst, axis_name="dp", flag=flag)
        return sp, res, gst, loss

    return step, (shards, residual, resilience.init_guard_state(device))


def make_batch(mesh, *, batch_per_replica=2, seq=16, vocab=64, seed=1,
               device=None):
    """This rank's rows of the token and label batch: the data axis takes
    its ``batch_per_replica`` rows of the ``batch_per_replica * data``
    drawn as JAX draws them (every model rank sees the same rows); int64,
    on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    rows = batch_per_replica * mesh.data
    tokens = rng.randint(0, vocab, (rows, seq))
    labels = rng.randint(0, vocab, (rows, seq))
    mine = slice(mesh.data_rank * batch_per_replica,
                 (mesh.data_rank + 1) * batch_per_replica)
    return (torch.from_numpy(tokens[mine]).long().to(device),
            torch.from_numpy(labels[mine]).long().to(device))
