"""The multi-tensor apply dispatcher.

Counterpart of ``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``
(reference apex/multi_tensor_apply/multi_tensor_apply.py:3-30):
``multi_tensor_applier(op, noop_flag, tensor_lists, *args)`` calls one of
the ops of :mod:`apex_tpu_torch.ops.multi_tensor`, which update their
tensors **in place**, as the reference's do (JAX's return new arrays),
and returns what the op returns (the norms' values; nothing for the
updates). The ops cut their lists into launches of up to 64 tensors
themselves, so ``chunk_size`` is kept for the reference's signature
only.
"""


class MultiTensorApply:
    available = True
    warned = False

    def __init__(self, chunk_size=2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args, **kwargs):
        return op(noop_flag, tensor_lists, *args, **kwargs)


multi_tensor_applier = MultiTensorApply(2048 * 32)
