"""Named random streams for tensor parallelism, and activation
checkpointing.

Counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``
(reference ``CudaRNGStatesTracker``, ``model_parallel_cuda_manual_seed``,
``checkpoint``). The tracker keeps one ``torch.Generator`` per name;
``fork`` draws a seed from the named stream, which advances it, and
yields a fresh generator seeded with it, the counterpart of JAX's split
key. :func:`model_parallel_seed` seeds the ``"default"`` stream with
``seed`` and the model-parallel stream with ``seed + 2718 + tp_rank``, as
the reference does, so the shards of a partitioned weight draw different
numbers and replicated ones the same. The numbers are not JAX's: the two
libraries' generators differ.
"""

import contextlib

import torch
import torch.utils.checkpoint

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.transformer import parallel_state

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_SEED_OFFSET = 2718


def model_parallel_rng_tracker_name():
    return _MODEL_PARALLEL_RNG_TRACKER_NAME


class RNGStatesTracker:
    """Named random streams (reference CudaRNGStatesTracker)."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        """Each stream's generator state (a byte tensor), by name."""
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states):
        for name, state in states.items():
            self.states_[name].set_state(state)

    def add(self, name, seed, device=None):
        """A stream ``name`` seeded with ``seed``, on the card unless the
        caller passes ``device="cpu"``."""
        if name in self.states_:
            raise Exception("RNG state {} already exists".format(name))
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
        self.states_[name] = gen

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield a fresh generator seeded from stream ``name``, which
        advances the stream."""
        if name not in self.states_:
            raise Exception("RNG state {} is not added".format(name))
        stream = self.states_[name]
        seed = int(torch.randint(0, 2 ** 62, (), generator=stream,
                                 device=stream.device))
        gen = torch.Generator(device=stream.device)
        gen.manual_seed(seed)
        yield gen


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_seed(seed: int, device=None):
    """Reset the tracker: the ``"default"`` stream from ``seed``, the
    model-parallel stream from ``seed + 2718 + tp_rank``."""
    tp_rank = parallel_state.get_tensor_model_parallel_rank()
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add("default", seed, device)
    _RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                           seed + _SEED_OFFSET + tp_rank, device)


# the reference's name
model_parallel_cuda_manual_seed = model_parallel_seed


def checkpoint(function, distribute_saved_activations=False, *args,
               **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (``torch.utils.checkpoint``, which replays the global random
    state). ``distribute_saved_activations`` (the saved input split over
    the tp ranks) is not supported."""
    if distribute_saved_activations:
        raise NotImplementedError(
            "checkpoint: distribute_saved_activations splits the saved input "
            "over the tp ranks, which this port does not do")
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False, **kwargs)
