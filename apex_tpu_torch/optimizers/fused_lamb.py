"""FusedLAMB: layer-wise adaptive moments with a trust ratio, over every
parameter of a group in one multi-tensor update.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py`` (reference
``apex/optimizers/fused_lamb.py``) with its arguments, in PyTorch's
idiom: ``step()`` takes the global L2 norm of every parameter's
``.grad`` (all groups together, as the reference does), then runs
:func:`apex_tpu_torch.ops.multi_tensor.multi_tensor_lamb` on each group
(the LAMB kernel for tensors on the card), which clips the gradients by
that norm, updates ``exp_avg`` / ``exp_avg_sq`` and the parameters in
place, and leaves each ``.grad`` holding its tensor's raw update until
``zero_grad``. The group's ``step`` counts the updates made; the first
is step 1.

    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    loss.backward(); opt.step(); opt.zero_grad()

The amp arguments of ``step`` (``found_inf``, ``scale``) belong to the
amp slice and raise.
"""

import torch

from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_l2norm,
    multi_tensor_lamb,
)
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, refuse_amp


class FusedLAMB(FusedOptimizerBase):
    """LAMB with decoupled (``adam_w_mode=True``) or L2 decay, optional
    bias correction, gradient averaging (beta3 = 1 - beta1), global
    gradient clipping at ``max_grad_norm`` and, with ``use_nvlamb``, the
    trust ratio also where ``weight_decay`` is 0."""

    state_names = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      grad_averaging=grad_averaging,
                                      max_grad_norm=max_grad_norm, step=0))
        self.adam_w_mode = adam_w_mode
        self.set_grad_none = set_grad_none
        self.use_nvlamb = use_nvlamb

    def zero_grad(self, set_to_none=None):
        """Drop the gradients (``set_grad_none``, the default) or zero
        them."""
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    @torch.no_grad()
    def step(self, closure=None, *, found_inf=None, scale=1.0):
        """One update of every parameter that has a gradient. Returns the
        closure's loss, if a closure is given."""
        refuse_amp(found_inf, scale)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        gathered = [(group, self._gather(group)) for group in self.param_groups]
        grads = [g for _, (gs, _, _) in gathered for g in gs]
        if not grads:
            return loss
        noop = self._noop(grads[0].device)
        global_norm, _ = multi_tensor_l2norm(noop, [grads])
        for group, (gs, params, (exp_avgs, exp_avg_sqs)) in gathered:
            if not params:
                continue
            group["step"] += 1
            beta1, beta2 = group["betas"]
            multi_tensor_lamb(
                noop, [gs, params, exp_avgs, exp_avg_sqs], group["lr"],
                beta1, beta2, group["eps"], group["step"],
                group["bias_correction"], group["weight_decay"],
                group["grad_averaging"], 1 if self.adam_w_mode else 0,
                global_norm, group["max_grad_norm"], self.use_nvlamb)
        return loss
