"""Per-tensor and per-module-prefix gradient and activation statistics,
computed on the card with no host synchronisation.

Counterpart of ``apex_tpu/telemetry/numerics.py``, with its fields,
thresholds, grouping and names. Mixed-precision training fails
silently: an fp16/bf16 under- or overflow shows up only as a tripped
loss scaler or a NaN loss, with no word of which tensor went bad. These
statistics say which.

- :func:`tensor_stats` — one :class:`TensorStats` of nine fp32 scalars
  a tensor: l2 norm, absmax, rms, zero fraction, non-finite count, and
  the fp16/bf16 under/overflow fractions against the formats' ranges.
- :func:`tree_stats` — a tree of tensors (dicts, lists, tuples; leaves
  named by their path, as ``jax.tree_util`` names them) aggregated into
  per-module-prefix groups (the first ``prefix_depth`` components of a
  leaf's path).

The sums come from K7, ``multi_tensor_stats``
(:mod:`apex_tpu_torch.kernels.stats`): one launch for up to 64 tensors
on the card, the plain PyTorch version for CPU tensors. The grouping is
decided on the host from the paths; the values stay on the device: a
group's nine fields are one row of an fp32 ``[G, 9]`` table, which
:func:`tree_stats`'s result carries as ``.table``, and nothing reaches
the host until :func:`stats_to_floats` or a post-mortem reads it.

Norm and fraction statistics count the FINITE elements only (non-finite
values are taken as 0), so the trend stays readable through a blow-up;
the poison is carried by the ``nonfinite`` count. An fp32 subnormal
reads as zero, as XLA's CPU and TPU backends flush it in the JAX
package's reductions. An ``inf`` therefore
counts as ``nonfinite``, not as an overflow. Env knob:
``APEX_TPU_NUMERICS_DEPTH`` sets the default grouping depth (default 2).
"""

import os
from typing import Dict, NamedTuple, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.kernels import stats as _k7
from apex_tpu_torch.kernels.stats import (  # noqa: F401
    BF16_MAX, BF16_TINY, FP16_MAX, FP16_TINY)

ENV_DEPTH = "APEX_TPU_NUMERICS_DEPTH"
DEFAULT_PREFIX_DEPTH = 2


class TensorStats(NamedTuple):
    """Nine fp32 scalars of one tensor or group. Fractions are over the
    group's element count; ``nonfinite`` is a count."""

    l2: torch.Tensor                   # sqrt(sum of squares of finite elems)
    absmax: torch.Tensor               # max |finite elem|
    rms: torch.Tensor                  # sqrt(mean square of finite elems)
    zero_frac: torch.Tensor            # fraction of exact (finite) zeros
    nonfinite: torch.Tensor            # COUNT of NaN/Inf elements
    fp16_overflow_frac: torch.Tensor   # finite |x| >  FP16_MAX
    fp16_underflow_frac: torch.Tensor  # finite 0 < |x| < FP16_TINY
    bf16_overflow_frac: torch.Tensor   # finite |x| >  BF16_MAX
    bf16_underflow_frac: torch.Tensor  # finite 0 < |x| < BF16_TINY


STAT_FIELDS = TensorStats._fields
NONFINITE = STAT_FIELDS.index("nonfinite")


class StatsDict(dict):
    """``{prefix: TensorStats}`` in sorted key order whose values are rows
    of one fp32 ``[G, 9]`` device table (``.table``, rows in key order):
    a recorder writes the table in one copy, and :func:`stats_to_floats`
    reads it in one."""

    table = None


def default_prefix_depth() -> int:
    return int(os.environ.get(ENV_DEPTH, str(DEFAULT_PREFIX_DEPTH)))


def group_prefix(path_str: str, prefix_depth: int) -> str:
    """First ``prefix_depth`` '/'-components of a leaf path — the
    module-prefix grouping key ("transformer/layer_3/attn/q_proj/w" at
    depth 2 -> "transformer/layer_3")."""
    parts = [p for p in path_str.split("/") if p]
    if not parts:
        return "<root>"
    return "/".join(parts[:max(1, int(prefix_depth))])


def _observed(leaf):
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.numel() > 0)


_N_CACHE = {}


def _counts_of(ns, device):
    """The groups' element counts as an fp32 device vector, made once a
    layout (no host copy in a step after the first)."""
    key = (tuple(ns), str(device))
    t = _N_CACHE.get(key)
    if t is None:
        t = _N_CACHE[key] = torch.tensor(ns, dtype=torch.float32,
                                         device=device)
    return t


def finalize(sums, counts, ns):
    """The ``[G, 9]`` fp32 table of :class:`TensorStats` rows from K7's
    group rows and the groups' element counts ``ns`` (host ints)."""
    n = _counts_of(ns, sums.device)
    sumsq, absmax = sums[:, 0], sums[:, 1]
    c = counts.to(torch.float32)
    return torch.stack([
        torch.sqrt(sumsq), absmax, torch.sqrt(sumsq / n), c[:, 0] / n,
        c[:, 1], c[:, 2] / n, c[:, 3] / n, c[:, 4] / n, c[:, 5] / n],
        dim=1)


def _rows(table, keys):
    out = StatsDict()
    for key, row in zip(keys, table.unbind(0)):
        out[key] = TensorStats(*row.unbind(0))
    out.table = table
    return out


def tensor_stats(x) -> TensorStats:
    """:class:`TensorStats` of one tensor, on its device (no host
    synchronisation). Raises on a non-float tensor."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        raise TypeError(
            f"tensor_stats: need a floating tensor, got "
            f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.numel() == 0:
        raise ValueError("tensor_stats: empty tensor")
    sums, counts = _k7.multi_tensor_stats([x])
    return TensorStats(*finalize(sums, counts, [x.numel()])[0].unbind(0))


def grouping(tree, prefix_depth: Optional[int] = None, *,
             prefix: Optional[str] = None):
    """The host side of :func:`tree_stats`: ``(keys, tensors, group_ids,
    ns)``: the sorted group keys, the observed leaves in tree order, each
    leaf's index into ``keys``, and each group's element count.
    Non-float and empty leaves are skipped."""
    if prefix_depth is None:
        prefix_depth = default_prefix_depth()
    leaves, names = [], []
    for path, leaf in _tree.flatten_with_path(tree):
        if not _observed(leaf):
            continue
        key = group_prefix(_tree.path_str(path), prefix_depth)
        if prefix:
            key = f"{prefix}/{key}"
        leaves.append(leaf)
        names.append(key)
    keys = sorted(set(names))
    index = {k: i for i, k in enumerate(keys)}
    ids = [index[k] for k in names]
    ns = [0] * len(keys)
    for leaf, g in zip(leaves, ids):
        ns[g] += leaf.numel()
    return keys, leaves, ids, ns


def tree_stats(tree, prefix_depth: Optional[int] = None, *,
               prefix: Optional[str] = None) -> Dict[str, TensorStats]:
    """Aggregate a tree of tensors into ``{module_prefix: TensorStats}``
    (sorted keys): one K7 pass over the leaves, each group's row the
    fold of its leaves' rows in tree order, as the JAX package's
    ``tree_stats`` folds them. ``prefix`` namespaces every key
    (``prefix="grads"`` -> ``"grads/<group>"``) so several stat sets can
    share one dict and one flight-recorder ring. Returns a
    :class:`StatsDict` (its ``.table`` the ``[G, 9]`` rows)."""
    keys, leaves, ids, ns = grouping(tree, prefix_depth, prefix=prefix)
    if not keys:
        out = StatsDict()
        out.table = torch.zeros((0, len(STAT_FIELDS)))
        return out
    sums, counts = _k7.multi_tensor_stats(leaves, ids, len(keys))
    return _rows(finalize(sums, counts, ns), keys)


def merge(*stats):
    """One :class:`StatsDict` of several (disjoint keys, e.g. the
    ``grads/`` and ``synced/`` sets), its table in sorted key order."""
    items = {}
    for s in stats:
        items.update(s)
    keys = sorted(items)
    if not keys:
        return StatsDict()
    table = torch.stack([torch.stack(list(items[k])) for k in keys])
    return _rows(table, keys)


def stats_table(stats):
    """The ``[G, 9]`` table of a stats dict, in its sorted key order."""
    table = getattr(stats, "table", None)
    if table is not None and list(stats) == sorted(stats):
        return table
    keys = sorted(stats)
    return torch.stack([torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                     for v in stats[k]]) for k in keys])


def module_grads(module):
    """``{path: grad}`` of a module's parameters that have a gradient, the
    parameter names' dots as ``/`` (``transformer/layers/3/mlp/...``), so
    :func:`tree_stats` groups them by module prefix."""
    return {name.replace(".", "/"): p.grad
            for name, p in module.named_parameters() if p.grad is not None}


def stats_to_floats(stats) -> Dict[str, Dict[str, float]]:
    """Host-side: one device-to-host copy of a ``{prefix: TensorStats}``
    dict into plain nested floats (JSON-ready)."""
    keys = sorted(stats)
    if not keys:
        return {}
    host = stats_table(stats).detach().cpu().tolist()
    return {k: {f: float(v) for f, v in zip(STAT_FIELDS, row)}
            for k, row in zip(keys, host)}


def first_nonfinite_prefix(stats_floats) -> Optional[str]:
    """First (sorted) module prefix whose non-finite count is > 0 in a
    host-side stats dict; None when everything is finite."""
    for k in sorted(stats_floats):
        if stats_floats[k].get("nonfinite", 0) > 0:
            return k
    return None
