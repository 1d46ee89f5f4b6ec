"""FusedAdam: Adam/AdamW over every parameter of a group in one
multi-tensor update.

Counterpart of ``apex_tpu/optimizers/fused_adam.py`` (reference
``apex/optimizers/fused_adam.py``) with its arguments, in PyTorch's
idiom: ``step()`` reads each parameter's ``.grad`` and updates the
parameter and its ``exp_avg`` / ``exp_avg_sq`` in place through
:func:`apex_tpu_torch.ops.multi_tensor.multi_tensor_adam` (the CUDA
kernel for tensors on the card). The group's ``step`` counts the
updates made; the first is step 1.

    opt = FusedAdam(model.parameters(), lr=1e-4)
    loss.backward(); opt.step(); opt.zero_grad()

``master_weights`` and the amp arguments of ``step`` (``found_inf``,
``scale``) belong to the amp slice and raise.
"""

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_adam
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, refuse_amp


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
        if master_weights:
            raise NotImplementedError("master_weights (fp32 masters of "
                                      "low-precision params) come with the "
                                      "amp slice of apex_tpu_torch")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, step=0))
        self.adam_w_mode = adam_w_mode

    @torch.no_grad()
    def step(self, closure=None, *, found_inf=None, scale=1.0):
        """One update of every parameter that has a gradient. Returns the
        closure's loss, if a closure is given."""
        refuse_amp(found_inf, scale)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            grads, params, (exp_avgs, exp_avg_sqs) = self._gather(group)
            if not params:
                continue
            group["step"] += 1
            beta1, beta2 = group["betas"]
            multi_tensor_adam(
                self._noop(params[0].device),
                [grads, params, exp_avgs, exp_avg_sqs], group["lr"], beta1,
                beta2, group["eps"], group["step"],
                1 if self.adam_w_mode else 0, group["bias_correction"],
                group["weight_decay"])
        return loss
