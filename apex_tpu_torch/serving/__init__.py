"""apex_tpu_torch.serving: continuous-batching decode on the GPU.

Counterpart of ``apex_tpu.serving``: a
:class:`~apex_tpu_torch.serving.engine.ServeEngine` runs bucketed
prefill and decode over a preallocated, slotted, optionally int8 KV
cache (:mod:`~apex_tpu_torch.serving.kv_cache`), and a host-side
:class:`~apex_tpu_torch.serving.scheduler.Scheduler` batches concurrent
requests through it: admission into free slots, eviction on finish,
per-request TTFT and per-token latency, admission control, deadlines,
per-slot NaN quarantine, decode retries and drain
(:mod:`~apex_tpu_torch.serving.robust`). ``ServeConfig(draft_model=...)``
makes each decode call one speculative round, and
``ServeConfig(prefix_cache=True)`` seeds a prompt's rows from a
host-side :class:`~apex_tpu_torch.serving.prefix_cache.PrefixStore` of
prompts prefilled before, so only its suffix is prefilled. On the card
the engine captures one CUDA graph per bucket and replays it.
``ServeEngine.extract_kv_state`` and :func:`kv_payload_crc` are the donor
half of KV migration: a second engine inserts a checksummed payload into
its prefix store and resumes the request with a one-token suffix.

    from apex_tpu_torch.serving import (ServeConfig, ServeEngine,
                                        synthetic_trace)
    engine = ServeEngine(model, ServeConfig(
        batch_buckets=(2, 4, 8), prefill_buckets=(32, 64, 128),
        num_slots=8, cache_mode="int8"))
    completed, stats = engine.serve(synthetic_trace(16, seed=1))

Tensor-parallel serving: under a tp grid every rank builds its engine
over its shard with ``mesh=ServeMesh.from_grid()`` (JAX's ``(data=1,
tp)`` mesh) and runs the same scheduler; the store holds each rank's
heads, and tp rank 0 decides what a rank's clock would. The fleet router
(ROADMAP queue A item 5(c)) and CUDA graphs at tp > 1 (item 5(d)) are
still to be ported.
"""

from apex_tpu_torch.serving.engine import (
    ServeConfig,
    ServeEngine,
    ServeMesh,
    kv_payload_crc,
)
from apex_tpu_torch.serving.kv_cache import (
    KVCacheSpec,
    payload_checksum,
    store_lengths,
)
from apex_tpu_torch.serving.prefix_cache import PrefixEntry, PrefixStore
from apex_tpu_torch.serving.robust import (
    DecodeFailedError,
    DrainReport,
    NonFiniteError,
    RejectedRequest,
    RobustConfig,
    ServeHealth,
)
from apex_tpu_torch.serving.scheduler import (
    CompletedRequest,
    Request,
    Scheduler,
    synthetic_trace,
)

__all__ = [
    "CompletedRequest", "DecodeFailedError", "DrainReport", "KVCacheSpec",
    "NonFiniteError", "PrefixEntry", "PrefixStore", "RejectedRequest",
    "Request", "RobustConfig", "Scheduler", "ServeConfig", "ServeEngine",
    "ServeHealth", "ServeMesh", "kv_payload_crc", "payload_checksum", "store_lengths",
    "synthetic_trace",
]
