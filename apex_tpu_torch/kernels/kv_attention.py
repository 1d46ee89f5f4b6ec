"""Launch plan of the KV-cache attention kernels #21 and #25
(``csrc/kv_attention.cuh``, behind :func:`fused_cc.window_attention` and
:func:`gqa_decode.gqa_flash_decode`).

A launch's grid is (b*g cells, row tiles of 16, S splits). :func:`plan`
picks S from the shapes and the SM count alone; the kernel then reads each row's offset on the device, finds its row tile's
live key range (:func:`live_range`) and cuts it into parts of whole
16-key steps, as many of the S as the range's length warrants
(:func:`split_keys`, the kernel's own rule). No length is read on the
host, so a call stays one launch and can be captured in a CUDA graph.

Splits merge in the same launch: each writes its partial softmax state
to fp32 scratch (:func:`workspace` allocates it) and bumps an int32
counter of its (cell, row tile); the last to arrive merges and sets the
counter back to 0. The counters are one tensor per device, zeroed once
when made and never freed (a captured graph keeps its pointer); launches
that share them must run in stream order, as one stream's do.
"""

import functools

import torch

STEP = 16             # keys of one tensor-core step
ROWS = 16             # query rows of a block: one tensor-core tile
MAX_SPLITS = 16       # the kernel's kMaxSplits
MIN_SPLIT_STEPS = 8   # the kernel's kMinSplitSteps

_counters = {}


def plan(n_rows: int, cells: int, sms: int):
    """(row tiles per cell, splits S) for ``cells`` cells of ``n_rows``
    query rows on a card of ``sms`` SMs, 16 rows a tile. S = 1 once the
    row tiles alone give every SM two blocks; otherwise S = ceil(4 * sms /
    blocks), at most MAX_SPLITS, so that a long live range fills the card
    about four times over (the kernel uses fewer splits for a short one:
    :func:`used_splits`)."""
    tiles = -(-n_rows // ROWS)
    blocks = max(1, cells * tiles)
    if blocks >= 2 * sms:
        return tiles, 1
    return tiles, max(1, min(MAX_SPLITS, -(-4 * sms // blocks)))


def live_range(start: int, row0: int, row_end: int, rep: int, window,
               cache_len: int):
    """Keys [t_lo, t_hi] (inclusive) that rows [row0, row_end) of a cell
    may see, the first row's window start to the last row's position;
    ``start`` is the position of the cell's window position 0 (decode:
    length - 1). Empty when t_hi < t_lo."""
    t_hi = min(start + (row_end - 1) // rep, cache_len - 1)
    t_lo = max(start + row0 // rep - window + 1, 0) if window else 0
    return t_lo, t_hi


def _steps(t_lo: int, t_hi: int) -> int:
    return (t_hi - t_lo) // STEP + 1 if t_hi >= t_lo else 0


def used_splits(t_lo: int, t_hi: int, splits: int) -> int:
    """How many of the grid's ``splits`` a range uses: one for every
    MIN_SPLIT_STEPS steps, at least one (merging splits costs a few L2
    round trips, so a short range runs unsplit)."""
    return max(1, min(splits, _steps(t_lo, t_hi) // MIN_SPLIT_STEPS))


def split_keys(t_lo: int, t_hi: int, split: int, splits: int):
    """Keys [lo, hi) of split ``split`` of the grid's ``splits``: the
    range's n = ceil((t_hi - t_lo + 1) / 16) steps cut at s * n // S' for
    the S' = :func:`used_splits` splits it uses (the rest are empty), so
    every key lies in exactly one split and the used parts differ by one
    step at most."""
    used = used_splits(t_lo, t_hi, splits)
    if split >= used:
        return t_lo, t_lo
    steps = _steps(t_lo, t_hi)
    j0 = steps * split // used
    j1 = steps * (split + 1) // used
    return t_lo + STEP * j0, min(t_lo + STEP * j1, t_hi + 1)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def counters(device, n: int) -> torch.Tensor:
    """The device's launch counters, at least ``n`` of them, all zero
    between launches. A larger set is made when needed; the old one is
    kept alive, as a captured graph may still point at it."""
    held = _counters.setdefault(device.index, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return held[-1]


def workspace(device, n_rows: int, cells: int, d: int, splits=None):
    """(splits, scratch, counters) for one launch. S comes from
    :func:`plan` unless ``splits`` is given (the kernel checks force it);
    with S = 1 the kernel takes neither scratch nor counters (None)."""
    tiles, planned = plan(n_rows, cells, sm_count(device.index))
    splits = planned if splits is None else splits
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits ({splits}) must be in [1, {MAX_SPLITS}]")
    if splits == 1:
        return 1, None, None
    slots = cells * tiles * splits
    scratch = torch.empty(slots * ROWS * (d + 2), dtype=torch.float32,
                          device=device)
    return splits, scratch, counters(device, cells * tiles)
