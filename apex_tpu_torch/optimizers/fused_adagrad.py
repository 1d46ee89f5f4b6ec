"""FusedAdagrad: Adagrad over every parameter of a group in one
multi-tensor update.

Counterpart of ``apex_tpu/optimizers/fused_adagrad.py`` (reference
``apex/optimizers/fused_adagrad.py``) with its arguments, in PyTorch's
idiom: ``step()`` reads each parameter's ``.grad`` and updates the
parameter and its ``sum`` (the running sum of squared gradients) in
place through the Adagrad kernel (:func:`apex_tpu_torch.kernels.optim.
adagrad`, JAX's ``multi_tensor_adagrad``): L2 decay into the gradient
or, with ``adagrad_w_mode``, decoupled decay.

    opt = FusedAdagrad(model.parameters(), lr=1e-2)
    loss.backward(); opt.step(); opt.zero_grad()

``step(found_inf=, scale=)`` (amp) skips the update where ``found_inf``
is > 0 and divides the gradients by ``scale`` inside it (JAX's
``g.astype(f32) / scale``); the group's ``step``, a one-element int32
tensor on the parameters' device, counts the clean steps there. The
parameters are fp32 (under amp O2, amp's fp32 masters, the parameters
written from them in the same pass).
"""

from apex_tpu_torch.kernels import optim as _kernels
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, divisor


class FusedAdagrad(FusedOptimizerBase):
    state_names = ("sum",)

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      weight_decay=weight_decay, step=0))
        self.adagrad_w_mode = adagrad_w_mode
        self.set_grad_none = set_grad_none

    def zero_grad(self, set_to_none=None):
        """Drop the gradients (``set_grad_none``, the default) or zero
        them."""
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _update(self, found_inf, scale, master_key=None):
        key = self._master_key(master_key)
        for group in self.param_groups:
            grads, targets, outs, (sums,) = self._gather(group, key)
            if not targets:
                continue
            device = targets[0].device
            flag = self._flag(found_inf, device)
            step = self._step_count(group, device)
            _kernels.adagrad(flag, grads, targets, sums, outs,
                             lr=group["lr"], eps=group["eps"],
                             weight_decay=group["weight_decay"],
                             mode=1 if self.adagrad_w_mode else 0,
                             scale=divisor(scale, device))
            self._advance(step, flag)
