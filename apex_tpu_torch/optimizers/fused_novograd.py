"""FusedNovoGrad: NovoGrad, Adam with one second moment a tensor (from
its gradient's norm), over every parameter of a group in one
multi-tensor update.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py`` (reference
``apex/optimizers/fused_novograd.py``) with its arguments, in PyTorch's
idiom: ``step()`` reads each parameter's ``.grad`` and updates the
parameter and its ``exp_avg`` in place through the NovoGrad kernel
(:func:`apex_tpu_torch.kernels.optim.novograd`, JAX's
``multi_tensor_novograd``). The second moments are one fp32 vector a
group on the parameters' device, ``group["exp_avg_sq"]``, one value for
each of the group's parameters in their order (as the reference keeps
them in the group, and JAX's state as one stacked vector); it goes
through ``state_dict`` / ``load_state_dict`` with the group.

    opt = FusedNovoGrad(model.parameters(), lr=1e-3, weight_decay=0.01)
    loss.backward(); opt.step(); opt.zero_grad()

``reg_inside_moment`` adds the L2 decay to the normalised gradient
(moment mode 0), else it is decoupled (mode 1); ``norm_type`` is 2 or
``float("inf")``; ``init_zero`` starts v at 0 (the first step takes
``(1 - beta2) * norm``, else the norm). The group's ``step`` is a
one-element int32 tensor on the parameters' device, advanced only on
clean steps: the kernel reads the first step and the bias correction
from it there. ``step(found_inf=, scale=)`` (amp) skips the update where
``found_inf`` is > 0 (v included) and divides the gradients by
``scale`` inside it.
"""

import torch

from apex_tpu_torch.kernels import optim as _kernels
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, divisor


class FusedNovoGrad(FusedOptimizerBase):
    state_names = ("exp_avg",)

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False,
                 grad_averaging=True, norm_type=2, init_zero=False,
                 set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        if norm_type not in (2, float("inf")):
            raise RuntimeError("FusedNovoGrad only supports l2/inf norm")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      grad_averaging=grad_averaging,
                                      norm_type=norm_type,
                                      init_zero=init_zero, step=0))
        self.moment_mode = 0 if reg_inside_moment else 1
        self.set_grad_none = set_grad_none

    def zero_grad(self, set_to_none=None):
        """Drop the gradients (``set_grad_none``, the default) or zero
        them."""
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    @staticmethod
    def _second_moments(group, device):
        """The group's ``exp_avg_sq``: an fp32 vector of one value for each
        of its parameters, on ``device`` (zeros at the first step; a saved
        one moved there once)."""
        v = group.get("exp_avg_sq")
        n = len(group["params"])
        if v is None:
            v = torch.zeros(n, dtype=torch.float32, device=device)
        elif (v.device, v.dtype) != (device, torch.float32):
            v = v.to(device=device, dtype=torch.float32)
        if v.shape != (n,):
            raise ValueError(f"FusedNovoGrad: exp_avg_sq holds {v.numel()} "
                             f"values for a group of {n} parameters")
        group["exp_avg_sq"] = v
        return v

    def _update(self, found_inf, scale, master_key=None):
        key = self._master_key(master_key)
        for group in self.param_groups:
            grads, targets, outs, (exp_avgs,) = self._gather(group, key)
            if not targets:
                continue
            device = targets[0].device
            flag = self._flag(found_inf, device)
            step = self._step_count(group, device)
            self._advance(step, flag)
            v = self._second_moments(group, device)
            slots = [k for k, p in enumerate(group["params"])
                     if p.grad is not None]
            beta1, beta2 = group["betas"]
            _kernels.novograd(
                flag, grads, targets, exp_avgs, v, outs, slots=slots,
                step=step, lr=group["lr"], b1=beta1, b2=beta2,
                beta3=(1 - beta1) if group["grad_averaging"] else 1.0,
                eps=group["eps"], weight_decay=group["weight_decay"],
                moment_mode=self.moment_mode,
                norm_type=2 if group["norm_type"] == 2 else 0,
                init_zero=group["init_zero"],
                bias_correction=group["bias_correction"],
                scale=divisor(scale, device))
