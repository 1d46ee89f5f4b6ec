"""FusedAdam: Adam/AdamW over every parameter of a group in one
multi-tensor update.

Counterpart of ``apex_tpu/optimizers/fused_adam.py`` (reference
``apex/optimizers/fused_adam.py``) with its arguments, in PyTorch's
idiom: ``step()`` reads each parameter's ``.grad`` and updates the
parameter and its ``exp_avg`` / ``exp_avg_sq`` in place through the
Adam kernel (:func:`apex_tpu_torch.kernels.optim.adam`, the body of
``multi_tensor_adam`` and its capturable forms). The group's ``step``
counts the updates made (the first is step 1): a one-element int32
tensor on the parameters' device, from which the kernel takes the bias
corrections.

    opt = FusedAdam(model.parameters(), lr=1e-4)
    loss.backward(); opt.step(); opt.zero_grad()

``master_weights=True`` keeps an fp32 master of each parameter (state
``"master"``): the update moves the master and the (bf16) parameter is
written from it in the same pass. ``step(found_inf=, scale=)`` (amp)
skips the update where ``found_inf`` is > 0 and divides the gradients by
``scale`` inside it, and the step count advances only on clean steps,
on the device: no step waits for the host.
"""

from apex_tpu_torch.kernels import optim as _kernels
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, inverse_scale


class FusedAdam(FusedOptimizerBase):
    """Adam (``adam_w_mode=False``: L2 decay added to the gradient) or
    AdamW (decoupled decay), with optional bias correction."""

    state_names = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, master_weights=False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, step=0))
        self.adam_w_mode = adam_w_mode
        self.master_weights = master_weights

    @property
    def keeps_masters(self):
        return self.master_weights

    def _update(self, found_inf, scale, master_key=None):
        key = self._master_key(master_key)
        for group in self.param_groups:
            grads, targets, outs, (exp_avgs, exp_avg_sqs) = self._gather(
                group, key)
            if not targets:
                continue
            device = targets[0].device
            flag = self._flag(found_inf, device)
            step = self._step_count(group, device)
            self._advance(step, flag)
            beta1, beta2 = group["betas"]
            corrections = (dict(step=step) if group["bias_correction"]
                           else dict(bc1=1.0, bc2=1.0))
            _kernels.adam(flag, grads, targets, exp_avgs, exp_avg_sqs, outs,
                          lr=group["lr"], b1=beta1, b2=beta2,
                          eps=group["eps"],
                          weight_decay=group["weight_decay"],
                          adam_w=self.adam_w_mode,
                          inv_scale=inverse_scale(scale, device),
                          **corrections)
