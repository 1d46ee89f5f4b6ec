"""FusedMixedPrecisionLamb: LAMB on fp32 masters of low-precision
parameters, with the grad scaler's ``found_inf`` and ``inv_scale``.

Counterpart of ``apex_tpu/optimizers/fused_mixed_precision_lamb.py``
(reference ``apex/optimizers/fused_mixed_precision_lamb.py``) with its
arguments, in PyTorch's idiom: each parameter (bf16 or fp32) keeps an
fp32 master (state ``"master"``, a tensor of its own even where the
parameter is fp32), ``exp_avg`` and ``exp_avg_sq``; ``step()`` takes the
global L2 norm of every ``.grad`` times ``1 / scale`` (all groups
together), then runs :func:`apex_tpu_torch.ops.multi_tensor.
multi_tensor_lamb_mp` on each group: the gradients (bf16 or fp32) times
``1 / scale`` inside the update, the masters and moments updated in
place, each parameter written from its new master in the same pass.

    opt = FusedMixedPrecisionLamb(model.parameters(), lr=1e-3)
    loss.backward(); opt.step(); opt.zero_grad()

The group's ``step`` is a one-element int32 tensor on the parameters'
device (the constructor's ``step`` at first), advanced on the device only
where ``found_inf`` is not > 0: an overflow-skipped step needs no host
synchronisation. ``reduced_precision_dtype`` is accepted for the
reference's signature; the masters are always fp32.
"""

from apex_tpu_torch.ops.multi_tensor import (
    multi_tensor_l2norm_scale,
    multi_tensor_lamb_mp,
)
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, inverse_scale


class FusedMixedPrecisionLamb(FusedOptimizerBase):
    state_names = ("exp_avg", "exp_avg_sq")
    keeps_masters = True

    def __init__(self, params, lr=1e-3, step=0, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False,
                 reduced_precision_dtype=None):
        if amsgrad:
            raise RuntimeError("FusedMixedPrecisionLamb does not support "
                               "AMSGrad.")
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction,
                                      betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      grad_averaging=grad_averaging,
                                      max_grad_norm=max_grad_norm, step=step))
        self.adam_w_mode = adam_w_mode
        self.set_grad_none = set_grad_none
        self.use_nvlamb = use_nvlamb

    def zero_grad(self, set_to_none=None):
        """Drop the gradients (``set_grad_none``, the default) or zero
        them."""
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _update(self, found_inf, scale, master_key=None):
        key = self._master_key(master_key)
        gathered = [(group, self._gather(group, key))
                    for group in self.param_groups]
        grads = [g for _, (gs, _, _, _) in gathered for g in gs]
        if not grads:
            return
        device = grads[0].device
        noop = self._flag(found_inf, device)
        inv = inverse_scale(scale, device)
        global_norm, _ = multi_tensor_l2norm_scale(
            noop, [grads], 1.0 if inv is None else inv)
        mode = 1 if self.adam_w_mode else 0
        for group, (gs, masters, params, (exp_avgs, exp_avg_sqs)) in gathered:
            if not masters:
                continue
            step = self._step_count(group, device)
            self._advance(step, noop)
            beta1, beta2 = group["betas"]
            multi_tensor_lamb_mp(
                noop, [gs, params, exp_avgs, exp_avg_sqs, masters],
                group["lr"], beta1, beta2, group["eps"], step,
                group["bias_correction"], group["weight_decay"],
                group["grad_averaging"], mode, global_norm,
                group["max_grad_norm"], self.use_nvlamb, noop,
                1.0 if inv is None else inv)
