"""AmpOptimizer: the optimizer wrapper that ``amp.initialize`` returns.

Counterpart of ``apex_tpu/amp/amp_optimizer.py`` (reference
apex/amp/_process_optimizer.py:321-489), with a torch optimizer's
interface (``step``, ``zero_grad``, ``param_groups``, ``state``,
``state_dict``). Its ``step()``, in JAX's order:

1. unscales every ``p.grad`` in place by 1 / the live loss scale (the
   multi-tensor scale kernel; each gradient in its own dtype, so a bf16
   gradient is rounded back to bf16, as JAX unscales with ``[leaves,
   leaves]``), which sets the overflow flag ``found_inf`` on the device;
2. steps the wrapped optimizer with ``found_inf``: under O2 on fp32
   masters that amp keeps (state ``"amp_master"``, copies of the already
   cast parameters, a tensor of their own even where a parameter is
   fp32), unless the wrapped optimizer keeps its own masters
   (``FusedAdam(master_weights=True)``, ``FusedMixedPrecisionLamb``);
   the low-precision parameters are written from the masters in the same
   pass; an overflowed step changes nothing, its step count included;
3. updates the loss scaler's state on the device.

Nothing in ``step()`` waits for the device: the flag, the scale and the
step counts stay there.
"""

import torch

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.ops.multi_tensor import multi_tensor_scale
from apex_tpu_torch.optimizers._base import master_copy


class AmpOptimizer:
    def __init__(self, optimizer, scaler: LossScaler, master_weights=False,
                 model_dtype=None):
        self.inner = optimizer
        self.scaler = scaler
        self.master_weights = master_weights
        self.model_dtype = model_dtype
        self.owns_masters = bool(master_weights) and not getattr(
            optimizer, "keeps_masters", False)
        self.last_found_inf = None
        if self.owns_masters:
            with torch.no_grad():
                for group in optimizer.param_groups:
                    for p in group["params"]:
                        optimizer.state[p]["amp_master"] = master_copy(p)

    # the wrapped optimizer's interface
    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @property
    def lr(self):
        return self.inner.param_groups[0]["lr"]

    def zero_grad(self, set_to_none=None):
        """The wrapped optimizer's ``zero_grad``, its own default where
        ``set_to_none`` is not given."""
        if set_to_none is None:
            self.inner.zero_grad()
        else:
            self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        """Unscale, step the wrapped optimizer with the overflow flag,
        update the scale. Returns the closure's loss, if one is given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        found_inf = self.unscale()[1]
        self.apply(found_inf)
        self.scaler._state = self.scaler.update(self.scaler._state,
                                                found_inf)
        self.last_found_inf = found_inf
        return loss

    @torch.no_grad()
    def unscale(self):
        """Step 1 alone: every ``p.grad`` unscaled in place by 1 / the live
        loss scale (K1). Returns ``(grads, found_inf)``, ``found_inf`` a
        one-element fp32 device flag. ``unscale``, ``apply`` and the
        scaler's ``update`` are what :meth:`step` runs; a guarded step
        (``resilience.guarded_update``) runs them apart, with its global
        flag in between."""
        grads = [p.grad for group in self.inner.param_groups
                 for p in group["params"] if p.grad is not None]
        state = self.scaler._state
        found_inf = torch.zeros(1, dtype=torch.float32,
                                device=self.scaler.device)
        if grads:
            multi_tensor_scale(found_inf, [grads, grads],
                               torch.reciprocal(state.loss_scale))
        return grads, found_inf

    @torch.no_grad()
    def apply(self, flag):
        """Step 2 alone: the wrapped optimizer's update, every write
        skipped on the device where ``flag`` (one fp32 element) is > 0;
        the scaler is not touched."""
        if hasattr(self.inner, "_update"):
            self.inner._update(flag, 1.0,
                               "amp_master" if self.owns_masters else None)
        elif self.owns_masters:
            raise TypeError(f"amp's master weights need one of the port's "
                            f"fused optimizers, got "
                            f"{type(self.inner).__name__}")
        else:  # a wrapper such as LARC: the flag passes through its step
            self.inner.step(found_inf=flag)

    def scale_loss(self, loss):
        """``loss`` in fp32 times the live loss scale."""
        return self.scaler.scale(loss)

    # checkpoints: the wrapped optimizer's state (masters included) and the
    # scaler's
    def state_dict(self):
        return {"inner": self.inner.state_dict(),
                "scaler": self.scaler.state_dict()}

    def load_state_dict(self, sd):
        if "inner" in sd:
            self.inner.load_state_dict(sd["inner"])
        self.scaler.load_state_dict(sd["scaler"])
