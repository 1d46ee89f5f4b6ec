"""Process-global amp state.

Counterpart of ``apex_tpu/amp/_amp_state.py`` (reference
apex/amp/_amp_state.py:8-59): the singleton that holds the opt-level
properties, the loss scalers and the wrapped optimizers of the last
``amp.initialize``.
"""


class AmpState:
    def __init__(self):
        self.hard_override = False
        self.allow_incoming_model_not_fp32 = False
        self.verbosity = 1
        self.opt_properties = None
        self.loss_scalers = []
        self.optimizers = []

    def reset(self):
        self.__init__()


_amp_state = AmpState()


def maybe_print(msg, rank0=False):
    if _amp_state.verbosity > 0:
        print(msg)


def master_params(optimizer):
    """The fp32 master tensors an :class:`~apex_tpu_torch.amp.AmpOptimizer`
    steps on (amp's own, or those its wrapped optimizer keeps), in the
    order of its parameters; nothing where there are none."""
    inner = getattr(optimizer, "inner", optimizer)
    for key in ("amp_master", "master"):
        masters = [inner.state[p][key] for group in inner.param_groups
                   for p in group["params"] if key in inner.state.get(p, {})]
        if masters:
            yield from masters
            return
