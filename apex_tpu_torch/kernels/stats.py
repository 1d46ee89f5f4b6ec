"""Multi-tensor numerics statistics (K7): the CUDA kernel (csrc/stats.cu)
and its plain PyTorch version.

The port's counterpart of the jnp reductions of
``apex_tpu/telemetry/numerics.py`` ``_raw_sums``, which XLA fuses into
the step (no Pallas kernel). For a list of tensors, each assigned to a
group, it returns the groups' rows: ``sums`` [G, 2] fp32 (the sum of
squares and the absmax of the finite elements; an fp32 subnormal reads
as zero, as XLA's CPU and TPU backends flush it in the JAX package's
reductions) and ``counts`` [G, 6]
int64 (zeros, non-finite, fp16 over- and underflows, bf16 over- and
underflows, against :data:`FP16_MAX`, :data:`FP16_TINY`,
:data:`BF16_MAX` and :data:`BF16_TINY`). A group's row folds its
tensors' rows in list order (sums of squares added in fp32, absmaxes
maxed, counts added), as ``tree_stats`` folds its leaves. Nothing is
read to the host.

CPU tensors take :func:`stats_plain`; CUDA tensors launch the kernel,
once per :data:`MAX_TENSORS` tensors, or raise.
"""

import ctypes
import functools

import torch

from apex_tpu_torch.kernels import _build, _checks, registry

MAX_TENSORS = 64   # tensors in one launch's table (kMaxTensors in the .cu)
CHUNK = 256 * 8 * 32  # elements of a chunk (kThreads * kPer * kBatches)
WORDS = 8          # 32-bit words of one chunk's partial
# dtype codes of apex_multi_tensor_stats
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# planted faults of apex_multi_tensor_stats (no caller passes them): each
# tensor's last chunk's non-finite count dropped; its first chunk counted
# twice
NONFINITE_DROPPED, CHUNK_TWICE = 1, 2

# numerics.py's representable-range thresholds (apex_tpu/telemetry/
# numerics.py:53-56): the largest finite magnitude and the smallest
# positive normal of fp16 and bf16
FP16_MAX = 65504.0
FP16_TINY = 6.103515625e-05          # 2**-14
BF16_MAX = 3.3895313892515355e+38
BF16_TINY = 1.1754943508222875e-38   # 2**-126

MULTI_TENSOR_STATS = registry.register("multi_tensor_stats")


def _tensor_row(x):
    """(sumsq, absmax) fp32 0-d and the six counts (int64 [6]) of one
    tensor, in PyTorch ops."""
    xf = x.reshape(-1).float()
    finite = torch.isfinite(xf)
    zero = torch.zeros((), device=xf.device)
    a = torch.where(finite, xf.abs(), zero)
    a = torch.where(a < BF16_TINY, zero, a)  # subnormals flushed, as XLA's
    pos = a > 0
    counts = torch.stack([
        (finite & (a == 0)).sum(), (~finite).sum(), (a > FP16_MAX).sum(),
        (pos & (a < FP16_TINY)).sum(), (a > BF16_MAX).sum(),
        (pos & (a < BF16_TINY)).sum()])
    return (a * a).sum(), a.max(), counts


def stats_plain(tensors, groups, n_groups):
    """The plain version: each tensor's row in PyTorch ops, folded into
    its group's in list order. Returns ``(sums [G, 2] fp32, counts [G, 6]
    int64)`` on the tensors' device."""
    device = tensors[0].device if tensors else torch.device("cpu")
    sums = [None] * n_groups
    counts = [None] * n_groups
    for x, g in zip(tensors, groups):
        if x.numel() == 0:
            continue
        ss, am, cs = _tensor_row(x)
        if sums[g] is None:
            sums[g], counts[g] = [ss, am], cs
        else:
            sums[g] = [sums[g][0] + ss, torch.maximum(sums[g][1], am)]
            counts[g] = counts[g] + cs
    zero = torch.zeros((), dtype=torch.float32, device=device)
    out_sums = torch.stack([torch.stack(s) if s is not None
                            else torch.stack([zero, zero]) for s in sums]) \
        if n_groups else torch.zeros((0, 2), device=device)
    out_counts = torch.stack([
        c if c is not None else torch.zeros(6, dtype=torch.int64,
                                            device=device)
        for c in counts]) if n_groups else torch.zeros(
            (0, 6), dtype=torch.int64, device=device)
    return out_sums, out_counts


@functools.lru_cache(maxsize=1)
def _kernel():
    p, i = _checks.ptr, ctypes.c_int
    return _build.function(
        "stats", "apex_multi_tensor_stats",
        [p, p, p, p, i, p, p, p, ctypes.c_longlong, i, p])


def scratch_words(sizes):
    """32-bit words of stats.cu's scratch for a launch over tensors of
    ``sizes`` elements: a partial of :data:`WORDS` words a chunk, a row
    of :data:`WORDS` words and a chunk count a tensor, and the rows'
    count."""
    return (WORDS * sum(-(-n // CHUNK) for n in sizes)
            + (WORDS + 1) * len(sizes) + 1)


def work(tensors):
    """(flops, bytes) of the statistics of ``tensors``: each element read
    once and squared and added (2 operations), the group rows aside."""
    n = sum(t.numel() for t in tensors)
    return 2.0 * n, float(sum(t.numel() * t.element_size()
                              for t in tensors))


def launch_stats(tensors, groups, sums, counts, *, fault=0):
    """The kernel over the list through its C function, adding into
    ``sums`` [G, 2] fp32 and ``counts`` [G, 6] int64 (zeroed by the
    caller); ``fault``: 0, or a planted fault's code. Returns the
    launches made, one per :data:`MAX_TENSORS` tensors. :func:`
    multi_tensor_stats` checks and counts; this does neither."""
    fn = _kernel()
    launches = 0
    device = sums.device
    for at in range(0, len(tensors), MAX_TENSORS):
        run = list(range(at, min(at + MAX_TENSORS, len(tensors))))
        n = len(run)
        sizes = [tensors[k].numel() for k in run]
        ptrs = (ctypes.c_void_p * n)(*[tensors[k].data_ptr() for k in run])
        csizes = (ctypes.c_longlong * n)(*sizes)
        cdtypes = (ctypes.c_int * n)(*[DTYPES[tensors[k].dtype]
                                       for k in run])
        cgroups = (ctypes.c_int * n)(*[int(groups[k]) for k in run])
        scratch = torch.zeros(scratch_words(sizes), dtype=torch.int32,
                              device=device)
        with torch.cuda.device(device):
            rc = fn(ptrs, csizes, cdtypes, cgroups, n, sums.data_ptr(),
                    counts.data_ptr(), scratch.data_ptr(), scratch.numel(),
                    int(fault), _checks.stream(sums))
        _checks.status("multi_tensor_stats", rc)
        launches += 1
    return launches


def _check(tensors, groups, n_groups):
    if len(groups) != len(tensors):
        raise ValueError(f"multi_tensor_stats: {len(tensors)} tensors but "
                         f"{len(groups)} group ids")
    for t in tensors:
        if t.dtype not in DTYPES:
            raise TypeError(f"multi_tensor_stats: tensors must be float32, "
                            f"bfloat16 or float16, got {t.dtype}")
    if any(not 0 <= int(g) < n_groups for g in groups):
        raise ValueError(f"multi_tensor_stats: group ids {list(groups)} do "
                         f"not index {n_groups} groups")


def multi_tensor_stats(tensors, groups=None, n_groups=None):
    """The groups' statistics rows of ``tensors`` (fp32, bf16 or fp16;
    ``groups[k]`` tensor k's group, default one group a tensor):
    ``(sums [G, 2] fp32, counts [G, 6] int64)`` on the tensors' device,
    with no host synchronisation. CPU tensors take :func:`stats_plain`;
    CUDA tensors launch the kernel (a non-contiguous tensor is read
    through a contiguous copy), or raise."""
    tensors = list(tensors)
    groups = list(range(len(tensors))) if groups is None else list(groups)
    n_groups = len(tensors) if n_groups is None else int(n_groups)
    _check(tensors, groups, n_groups)
    if not tensors or not _checks.on_cuda("multi_tensor_stats", *tensors):
        return stats_plain(tensors, groups, n_groups)
    tensors = [t if t.is_contiguous() else t.contiguous() for t in tensors]
    device = tensors[0].device
    sums = torch.zeros((n_groups, 2), dtype=torch.float32, device=device)
    counts = torch.zeros((n_groups, 6), dtype=torch.int64, device=device)
    live = [(t, g) for t, g in zip(tensors, groups) if t.numel()]
    if not live:
        return sums, counts
    ts, gs = [t for t, _ in live], [g for _, g in live]
    for at in range(0, len(ts), MAX_TENSORS):
        flops, nbytes = work(ts[at:at + MAX_TENSORS])
        launch_stats(ts[at:at + MAX_TENSORS], gs[at:at + MAX_TENSORS],
                     sums, counts)
        registry.count(MULTI_TENSOR_STATS, flops=flops, bytes=nbytes)
    return sums, counts
