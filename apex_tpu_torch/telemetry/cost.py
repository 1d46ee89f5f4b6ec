"""Step cost accounting: FLOPs and bytes of a step, and the achieved MFU
and HBM utilisation against the card's peaks.

Counterpart of ``apex_tpu/telemetry/xla_cost.py``. XLA's cost analysis
has no PyTorch counterpart, so :func:`step_cost` runs the step once and
counts two things:

- PyTorch's own operators (matmuls, convolutions, ``scaled_dot_product_
  attention``) under ``torch.utils.flop_counter.FlopCounterMode``;
- the port's own kernels, which that mode cannot see (they are
  ``ctypes`` calls): each wrapper adds its operations and bytes,
  reckoned from its shapes, to :mod:`apex_tpu_torch.kernels.registry`
  beside its launch count, and the step's share of those totals is
  added here.

The peak table is keyed by the card's name (``torch.cuda.
get_device_name()``); the H100 SXM entry is NVIDIA's data-sheet figures
at 700 W. ``APEX_TPU_PEAK_TFLOPS`` and ``APEX_TPU_PEAK_HBM_GBPS``
override them. :func:`utilization` and :func:`record_step_cost` keep
the JAX package's names, gauges and ``xla_cost`` event, so the readers
of its sink render this one.
"""

import os

import torch

from apex_tpu_torch.kernels import registry as _kernels

# (peak operations/s by dtype, peak memory bytes/s), by a substring of
# the card's name: NVIDIA's H100 SXM data sheet, dense tensor-core rates
_PEAKS = {
    "H100": ({"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}, 3.35e12),
}
# the host where there is no card: order-of-magnitude placeholders for
# tests, not a roofline
_CPU_PEAK = ({"bfloat16": 0.1e12, "float16": 0.1e12, "tf32": 0.1e12,
              "float32": 0.1e12}, 0.05e12)


def device_name():
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def peak_table(name=None, dtype="bfloat16"):
    """``(peak_flops_per_sec, peak_hbm_bytes_per_sec)`` of the card named
    ``name`` (default this process's card) for ``dtype``'s tensor-core or
    FMA rate, honoring the env overrides. A card without an entry takes
    the host's placeholders."""
    name = device_name() if name is None else name
    flops_by, hbm = _CPU_PEAK
    for key, entry in _PEAKS.items():
        if key in name:
            flops_by, hbm = entry
            break
    flops = flops_by.get(dtype, flops_by["bfloat16"])
    env_flops = os.environ.get("APEX_TPU_PEAK_TFLOPS")
    if env_flops:
        flops = float(env_flops) * 1e12
    env_hbm = os.environ.get("APEX_TPU_PEAK_HBM_GBPS")
    if env_hbm:
        hbm = float(env_hbm) * 1e9
    return flops, hbm


def step_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count its work: ``{"flops",
    "bytes_accessed", "torch_flops", "kernel_flops", "kernel_bytes",
    "by_kernel"}``. ``torch_flops`` is what ``FlopCounterMode`` counted of
    PyTorch's operators (backward passes run inside the call included),
    ``kernel_flops``/``kernel_bytes`` what the port's kernels added to
    the launch registry during the call; ``flops`` is their sum.
    ``bytes_accessed`` is None: PyTorch's operators report no bytes, so
    no HBM utilisation is claimed from a count that misses them."""
    from torch.utils.flop_counter import FlopCounterMode

    before = _kernels.work()
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    after = _kernels.work()
    by_kernel = {}
    for name, w in after.items():
        b = before.get(name, {"flops": 0.0, "bytes": 0.0})
        df, db = w["flops"] - b["flops"], w["bytes"] - b["bytes"]
        if df or db:
            by_kernel[name] = {"flops": df, "bytes": db}
    torch_flops = float(counter.get_total_flops())
    kernel_flops = sum(v["flops"] for v in by_kernel.values())
    return {"flops": torch_flops + kernel_flops, "bytes_accessed": None,
            "torch_flops": torch_flops, "kernel_flops": kernel_flops,
            "kernel_bytes": sum(v["bytes"] for v in by_kernel.values()),
            "by_kernel": by_kernel}


def utilization(flops_per_step, step_seconds, *, bytes_per_step=None,
                name=None, dtype="bfloat16"):
    """Achieved fractions of peak: ``{"mfu", "hbm_util", ...}``. ``mfu``
    is FLOP/s over the card's peak for ``dtype`` (pass model FLOPs for
    the classic MFU); ``hbm_util`` bytes/s over its memory rate."""
    peak_flops, peak_hbm = peak_table(name, dtype)
    out = {
        "flops_per_sec": flops_per_step / step_seconds,
        "mfu": flops_per_step / step_seconds / peak_flops,
    }
    if bytes_per_step is not None:
        out["bytes_per_sec"] = bytes_per_step / step_seconds
        out["hbm_util"] = bytes_per_step / step_seconds / peak_hbm
    return out


def record_step_cost(cost, step_seconds, *, registry=None, name=None,
                     dtype="bfloat16"):
    """Fold a :func:`step_cost` result and a measured step time into the
    registry: the ``mfu`` / ``hbm_util`` / ``model_flops_per_step_xla``
    gauges and an ``xla_cost`` event (the JAX package's names). Returns
    the :func:`utilization` dict (or None)."""
    from apex_tpu_torch.telemetry.registry import get_registry

    if cost is None or not step_seconds:
        return None
    util = utilization(cost["flops"], step_seconds,
                       bytes_per_step=cost.get("bytes_accessed"),
                       name=name, dtype=dtype)
    reg = registry or get_registry()
    if reg.enabled:
        reg.gauge("model_flops_per_step_xla").set(cost["flops"])
        reg.gauge("mfu").set(util["mfu"])
        if "hbm_util" in util:
            reg.gauge("hbm_util").set(util["hbm_util"])
        reg.event("xla_cost", "step",
                  flops=cost["flops"],
                  bytes_accessed=cost.get("bytes_accessed"),
                  step_seconds=step_seconds,
                  mfu=util["mfu"], hbm_util=util.get("hbm_util"))
    return util
