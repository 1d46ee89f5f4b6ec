"""Shared machinery of the fused optimizers.

Counterpart of ``apex_tpu/optimizers/_base.py``. The JAX optimizers are
pure ``step(grads, state, params)`` functions over pytrees; here they
follow PyTorch's idiom instead: a ``torch.optim.Optimizer`` whose
``step()`` reads ``p.grad`` and updates parameters and per-parameter
state in place, one multi-tensor op per parameter group.
"""

import torch


def refuse_amp(found_inf, scale):
    """Overflow skipping and loss-scale folding belong to amp, which the
    port does not have yet: refuse them instead of ignoring them."""
    if found_inf is not None or scale != 1.0:
        raise NotImplementedError(
            "found_inf / scale (amp's overflow skip and loss scale) come "
            "with the amp slice of apex_tpu_torch")


class FusedOptimizerBase(torch.optim.Optimizer):
    """An optimizer whose per-parameter state is the fp32 buffers named
    in ``state_names``, created as zeros at a parameter's first step."""

    state_names = ()

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        self._noops = {}

    def _gather(self, group):
        """(grads, params, [one list per state name]) of the group's
        parameters that have a gradient."""
        grads, params = [], []
        buffers = [[] for _ in self.state_names]
        for p in group["params"]:
            if p.grad is None:
                continue
            if p.grad.is_sparse:
                raise RuntimeError(f"{type(self).__name__} does not support "
                                   f"sparse gradients")
            state = self.state[p]
            for name, out in zip(self.state_names, buffers):
                if name not in state:
                    state[name] = torch.zeros_like(p, dtype=torch.float32)
                out.append(state[name])
            grads.append(p.grad)
            params.append(p)
        return grads, params, buffers

    def _noop(self, device):
        """The device-side overflow flag the multi-tensor ops read: always
        0 until amp sets it."""
        if device not in self._noops:
            self._noops[device] = torch.zeros(1, dtype=torch.float32,
                                              device=device)
        return self._noops[device]
