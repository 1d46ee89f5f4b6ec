"""Model-parallel grad scaler.

Counterpart of ``apex_tpu/transformer/amp/grad_scaler.py`` (reference
apex/transformer/amp/grad_scaler.py:21-125): a loss scaler whose
``found_inf`` is the MAX over the model-parallel ranks (the ``"tp"`` and
``"pp"`` axes of :mod:`apex_tpu_torch.parallel.groups`, each where it is
bound to more than one rank), through ``torch.distributed``, so every
model-parallel rank skips, or steps, together. At one rank that is the
identity.

Its ``update`` is JAX's: the scale times ``backoff_factor`` on an
overflow and times ``growth_factor`` after ``growth_interval`` clean
steps, with no floor and no ``max_loss_scale`` clamp (JAX's :44-56;
reproduced, not fixed).
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.parallel import groups
from apex_tpu_torch.transformer.parallel_state import TENSOR_PARALLEL_AXIS

PIPELINE_PARALLEL_AXIS = "pp"


class GradScaler(LossScaler):
    def __init__(self, init_scale=2.0 ** 16, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000, enabled=True,
                 axis_names=(TENSOR_PARALLEL_AXIS, PIPELINE_PARALLEL_AXIS),
                 device=None):
        super().__init__("dynamic", init_scale=init_scale,
                         scale_factor=growth_factor,
                         scale_window=growth_interval, device=device)
        self._backoff_factor = backoff_factor
        self.axis_names = axis_names
        self.enabled = enabled

    def all_reduce_found_inf(self, found_inf):
        """``found_inf``'s MAX over each bound model-parallel axis (a new
        tensor where one is reduced; ``found_inf`` itself at one rank)."""
        for ax in self.axis_names:
            if groups.axis_size(ax) > 1:
                found_inf = found_inf.clone()
                dist.all_reduce(found_inf, op=dist.ReduceOp.MAX,
                                group=groups.axis_group(ax))
        return found_inf

    def unscale_grads(self, grads, state=None):
        grads, found_inf = super().unscale_grads(grads, state)
        return grads, self.all_reduce_found_inf(found_inf)

    def update(self, state, found_inf):
        found_inf = self.all_reduce_found_inf(found_inf)
        overflow = found_inf.reshape(()) > 0
        grow = state.unskipped + 1 >= self._scale_window
        new_scale = torch.where(
            overflow, state.loss_scale * self._backoff_factor,
            torch.where(grow, state.loss_scale * self._scale_factor,
                        state.loss_scale))
        new_unskipped = torch.where(overflow | grow, 0,
                                    state.unskipped + 1).to(torch.int32)
        return ScalerState(new_scale, new_unskipped)
