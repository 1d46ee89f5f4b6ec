"""FP16_Optimizer: the legacy wrapper that keeps fp32 master weights of a
half-precision model and steps them under a loss scale.

Counterpart of ``apex_tpu/fp16_utils/fp16_optimizer.py`` (reference
``apex/fp16_utils/fp16_optimizer.py``), in PyTorch's idiom: it wraps one
of the port's fused optimizers, built over the model's parameters, and
puts fp32 masters in their place in the optimizer's groups (each a
tensor of its own, never the parameter:
:func:`~apex_tpu_torch.optimizers._base.master_copy`), as reference
Apex does. Its methods have JAX's effects, in JAX's order:

- :meth:`backward` scales the loss and runs its backward;
- :meth:`update_master_grads` unscales the model gradients into the
  masters' fp32 ``.grad`` (``g.astype(f32) * (1 / scale)``, the
  multi-tensor scale kernel, bf16 in, fp32 out), reads the overflow flag
  on the host (JAX's ``bool(bad)``) and updates the scale;
- :meth:`clip_master_grads` scales the masters' gradients by
  ``min(1, max_norm / (total + 1e-6))``, total their global L2 norm;
- :meth:`step` unscales the model gradients again, by the scale current
  at the step, into the masters' gradients, takes the overflow flag from
  those products and runs the wrapped optimizer's update on the masters
  with that flag on the device (an overflowed step changes nothing; no
  host wait), the parameters written from the new masters in the same
  pass.

As in JAX, :meth:`step` does not read what :meth:`update_master_grads`
or :meth:`clip_master_grads` left: it unscales afresh, so a scale that
:meth:`update_master_grads` grew or halved is the one :meth:`step`
divides by.
"""

import torch

from apex_tpu_torch.fp16_utils.loss_scaler import DynamicLossScaler, LossScaler
from apex_tpu_torch.ops.multi_tensor import multi_tensor_scale
from apex_tpu_torch.optimizers._base import FusedOptimizerBase, master_copy


class FP16_Optimizer:
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=False):
        if not isinstance(init_optimizer, FusedOptimizerBase):
            raise TypeError(f"FP16_Optimizer wraps one of the port's fused "
                            f"optimizers, got {type(init_optimizer).__name__}")
        if init_optimizer.keeps_masters:
            raise TypeError(f"FP16_Optimizer keeps the fp32 masters itself: "
                            f"wrap a {type(init_optimizer).__name__} without "
                            f"masters of its own")
        self.inner = self.optimizer = init_optimizer
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.overflow = False
        self.first_closure_call_this_step = True
        self.verbose = verbose
        self.model_params, self.masters = [], []
        with torch.no_grad():
            for group in init_optimizer.param_groups:
                masters = [master_copy(p) for p in group["params"]]
                for p, m in zip(group["params"], masters):
                    init_optimizer.written_from[id(m)] = p
                self.model_params += group["params"]
                self.masters += masters
                group["params"] = masters

    @property
    def loss_scale(self):
        return self.loss_scaler.loss_scale

    @property
    def param_groups(self):
        """The wrapped optimizer's groups, which hold the masters."""
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none=True):
        """Drop (or zero) the model's gradients and the masters'."""
        for p in self.model_params + self.masters:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.zero_()

    def backward(self, loss, retain_graph=False):
        """Backward of ``loss`` times the loss scale; returns that
        product."""
        return self.loss_scaler.backward(loss, retain_graph=retain_graph)

    @torch.no_grad()
    def _unscale(self):
        """Each model gradient times 1 / the current scale, in fp32, into
        its master's ``.grad`` (made where missing; None where the
        parameter has none); returns the overflow flag of those products,
        a one-element fp32 tensor on the device."""
        grads, outs = [], []
        for p, m in zip(self.model_params, self.masters):
            if p.grad is None:
                m.grad = None
                continue
            if m.grad is None:
                m.grad = torch.empty_like(m)
            grads.append(p.grad)
            outs.append(m.grad)
        device = self.masters[0].device if self.masters else "cpu"
        flag = torch.zeros(1, dtype=torch.float32, device=device)
        if grads:
            multi_tensor_scale(flag, [grads, outs],
                               1.0 / self.loss_scaler.loss_scale)
        return flag

    def update_master_grads(self):
        """Unscale the model gradients into the masters' fp32 ``.grad``,
        set :attr:`overflow` (one host read) and update the loss scale.
        Returns the master gradients."""
        flag = self._unscale()
        self.overflow = bool(flag.item() > 0)
        self.loss_scaler.update_scale(self.overflow)
        return [m.grad for m in self.masters]

    @torch.no_grad()
    def clip_master_grads(self, max_norm, norm_type=2):
        """Scale the masters' gradients by ``min(1, max_norm / (total +
        1e-6))`` in place, total their global L2 norm (``norm_type`` is
        accepted for the reference's signature; JAX takes the L2 norm);
        returns total, a 0-d fp32 tensor on the device."""
        grads = [m.grad for m in self.masters if m.grad is not None]
        if not grads:
            return torch.zeros(())
        total = torch.sqrt(torch.stack(
            [torch.square(g).sum() for g in grads]).sum())
        factor = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        torch._foreach_mul_(grads, factor)
        return total

    @torch.no_grad()
    def step(self, closure=None):
        """Unscale the model gradients by the current scale into the
        masters' gradients, step the wrapped optimizer on the masters with
        the overflow flag of those products on the device (skipped where
        it is set), the parameters written from the new masters. Returns
        the closure's loss, if one is given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        flag = self._unscale()
        self.inner._update(flag, 1.0)
        self.first_closure_call_this_step = True
        return loss

    def state_dict(self):
        """JAX's scaler entries, the wrapped optimizer's state and the
        fp32 masters."""
        sd = {"loss_scale": self.loss_scaler.loss_scale,
              "overflow": self.overflow,
              "optimizer_state_dict": self.inner.state_dict(),
              "fp32_master": [m.detach().clone() for m in self.masters]}
        if isinstance(self.loss_scaler, DynamicLossScaler):
            sd["cur_iter"] = self.loss_scaler.cur_iter
            sd["last_overflow_iter"] = self.loss_scaler.last_overflow_iter
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd):
        self.overflow = sd.get("overflow", False)
        self.loss_scaler.cur_scale = sd["loss_scale"]
        if isinstance(self.loss_scaler, DynamicLossScaler):
            self.loss_scaler.cur_iter = sd.get("cur_iter", 0)
            self.loss_scaler.last_overflow_iter = sd.get(
                "last_overflow_iter", -1)
        if "optimizer_state_dict" in sd:
            self.inner.load_state_dict(sd["optimizer_state_dict"])
        for m, saved in zip(self.masters, sd.get("fp32_master", ())):
            m.copy_(saved)
