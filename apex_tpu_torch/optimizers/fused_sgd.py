"""FusedSGD: SGD with momentum over every parameter of a group in one
multi-tensor update.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py`` (reference
``apex/optimizers/fused_sgd.py``) with its arguments, in PyTorch's
idiom: ``step()`` reads each parameter's ``.grad`` and updates the
parameter and its ``momentum_buffer`` in place through the SGD kernel
(:func:`apex_tpu_torch.kernels.optim.sgd`, JAX's ``multi_tensor_sgd``):
momentum, dampening, nesterov, L2 decay before the momentum or, with
``wd_after_momentum``, after it. The first update takes the gradient as
the momentum buffer (``first_run``).

    opt = FusedSGD(model.parameters(), lr=0.1, momentum=0.9)
    loss.backward(); opt.step(); opt.zero_grad()

The group's ``step`` is a one-element int32 tensor on the parameters'
device, as JAX's ``state["step"]``: ``first_run`` is read from it on the
device, and ``step(found_inf=, scale=)`` (amp) skips the update where
``found_inf`` is > 0, leaving the count, so the next clean step is still
the first; the gradients are divided by ``scale`` inside the update. The
parameters are fp32 (under amp O2, amp's fp32 masters, the parameters
written from them in the same pass); ``materialize_master_grads`` is
accepted for the reference's signature and has no effect.
"""

from apex_tpu_torch.kernels import optim as _kernels
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, inverse_scale


class FusedSGD(FusedOptimizerBase):
    state_names = ("momentum_buffer",)

    def __init__(self, params, lr=None, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=False):
        if lr is None:
            raise ValueError("FusedSGD requires a learning rate")
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      dampening=dampening,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov, step=0))
        self.wd_after_momentum = wd_after_momentum
        self.set_grad_none = set_grad_none

    def zero_grad(self, set_to_none=None):
        """Zero the gradients, or drop them with ``set_grad_none``."""
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _update(self, found_inf, scale, master_key=None):
        key = self._master_key(master_key)
        for group in self.param_groups:
            grads, targets, outs, (moms,) = self._gather(group, key)
            if not targets:
                continue
            device = targets[0].device
            noop = self._flag(found_inf, device)
            step = self._step_count(group, device)
            _kernels.sgd(noop, grads, targets, moms, outs, step=step,
                         inv_scale=inverse_scale(scale, device),
                         wd=group["weight_decay"],
                         momentum=group["momentum"],
                         dampening=group["dampening"], lr=group["lr"],
                         nesterov=group["nesterov"],
                         wd_after_momentum=self.wd_after_momentum)
            self._advance(step, noop)
