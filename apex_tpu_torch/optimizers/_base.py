"""Shared machinery of the fused optimizers.

Counterpart of ``apex_tpu/optimizers/_base.py``. The JAX optimizers are
pure ``step(grads, state, params)`` functions over pytrees; here they
follow PyTorch's idiom instead: a ``torch.optim.Optimizer`` whose
``step()`` reads ``p.grad`` and updates parameters and per-parameter
state in place, one multi-tensor op per parameter group.

Every step takes one path. The group's step count is a one-element
int32 tensor on the parameters' device (:meth:`FusedOptimizerBase.
_step_count`), advanced there only where amp's ``found_inf`` is not > 0
(JAX's ``step + where(noop > 0, 0, 1)``); the kernels read it, and the
bias corrections they take from it, on the device, so an
overflow-skipped step needs no host synchronisation.
"""

import torch

from apex_tpu_torch.ops.multi_tensor import device_scalar


def resolve_found_inf(found_inf, device):
    """The overflow flag a step reads: ``found_inf`` (a number or a tensor
    of one element; None: 0) as a one-element fp32 tensor on ``device``
    (:func:`~apex_tpu_torch.ops.multi_tensor.device_scalar`)."""
    return device_scalar(0.0 if found_inf is None else found_inf, device)


def inverse_scale(scale, device):
    """``1 / scale`` as the kernels multiply by it: None (no product) for
    the number 1, else a one-element fp32 tensor on ``device`` (JAX's
    ``1.0 / scale``: a double rounded to fp32, or an fp32 division)."""
    if isinstance(scale, torch.Tensor):
        return torch.reciprocal(scale.to(device=device, dtype=torch.float32)
                                ).reshape(1)
    if scale == 1.0:
        return None
    return torch.full((1,), 1.0 / scale, dtype=torch.float32, device=device)


def divisor(scale, device):
    """``scale`` as the Adagrad and NovoGrad kernels divide by it (JAX's
    ``g.astype(f32) / scale``): None (no division) for the number 1, else
    a one-element fp32 tensor on ``device``."""
    if not isinstance(scale, torch.Tensor) and scale == 1.0:
        return None
    return device_scalar(scale, device)


def master_copy(p, dtype=torch.float32):
    """An fp32 master of ``p``: always a tensor of its own, never ``p``
    itself, even where ``p`` is already fp32 (a norm parameter under amp
    O2). JAX's ``master_copy_tree`` docstring (apex_tpu/optimizers/
    _base.py:31-48) gives the hazard: a master that aliases its parameter
    is updated twice a step (here: in place, then again as the parameter
    written from it)."""
    return p.detach().to(dtype=dtype, copy=True)


def master_copy_tree(params, dtype=torch.float32):
    """:func:`master_copy` of every tensor of ``params`` (a tensor, a
    list, tuple or dict of them, nested)."""
    if isinstance(params, torch.Tensor):
        return master_copy(params, dtype)
    if isinstance(params, dict):
        return {k: master_copy_tree(v, dtype) for k, v in params.items()}
    return type(params)(master_copy_tree(v, dtype) for v in params)


class FusedOptimizerBase(torch.optim.Optimizer):
    """An optimizer whose per-parameter state is the fp32 buffers named
    in ``state_names``, created as zeros at a parameter's first step.
    ``keeps_masters``: the optimizer updates fp32 masters of its
    parameters (state ``"master"``) and writes the parameters from them."""

    state_names = ()
    keeps_masters = False

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        self._noops = {}
        # id(target) -> the tensor to write from it in the same pass: the
        # low-precision parameters of masters that a wrapper holds in the
        # groups (fp16_utils.FP16_Optimizer)
        self.written_from = {}

    @torch.no_grad()
    def step(self, closure=None, *, found_inf=None, scale=1.0):
        """One update of every parameter that has a gradient, skipped
        where ``found_inf`` (a device tensor of one element, amp's
        overflow flag) is > 0; gradients are unscaled by ``scale`` first.
        Returns the closure's loss, if a closure is given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._update(found_inf, scale)
        return loss

    def load_state_dict(self, state_dict):
        """``torch.optim.Optimizer.load_state_dict``, but each state tensor
        keeps its saved dtype (torch casts floating state to its
        parameter's dtype, which would round fp32 moments and masters of a
        bf16 parameter to bf16); tensors move to the parameter's
        device."""
        saved = state_dict["state"]
        super().load_state_dict({**state_dict, "state": {}})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            if i in saved:
                self.state[p] = {
                    k: v.to(p.device) if isinstance(v, torch.Tensor) else v
                    for k, v in saved[i].items()}

    def _update(self, found_inf, scale, master_key=None):
        """The step itself. ``master_key`` names the state entry of fp32
        masters to update in place of the parameters, which are then
        written from them ("amp_master": masters that amp keeps); None
        takes the optimizer's own ("master" where it keeps masters)."""
        raise NotImplementedError

    def _master_key(self, master_key):
        return master_key or ("master" if self.keeps_masters else None)

    def _gather(self, group, master_key=None):
        """(grads, targets, outs, [one list per state name]) of the
        group's parameters that have a gradient: a target is the tensor
        the update moves (the parameter, or its fp32 master under
        ``master_key``, created at its first step), an out the parameter
        written from its master (None where the target is the parameter,
        unless :attr:`written_from` names one for it)."""
        grads, targets, outs = [], [], []
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
            if master_key is None:
                targets.append(p)
                outs.append(self.written_from.get(id(p)))
            else:
                if master_key not in state:
                    state[master_key] = master_copy(p)
                targets.append(state[master_key])
                outs.append(p)
        return grads, targets, outs, buffers

    def _flag(self, found_inf, device):
        """The overflow flag a step reads on ``device``: ``found_inf`` as
        :func:`resolve_found_inf` gives it, or, where it is None, a zero
        flag kept for the device."""
        if found_inf is not None:
            return resolve_found_inf(found_inf, device)
        if device not in self._noops:
            self._noops[device] = torch.zeros(1, dtype=torch.float32,
                                              device=device)
        return self._noops[device]

    @staticmethod
    def _step_count(group, device):
        """The group's step count: a one-element int32 tensor on
        ``device``, stored back in the group (a count set as a number, as
        the constructor's and a loaded JAX state's are, or a tensor on
        another device, is converted once)."""
        step = group["step"]
        if not isinstance(step, torch.Tensor):  # filled there: no copy
            step = torch.full((1,), int(step), dtype=torch.int32,
                              device=device)
        elif (step.device, step.dtype, step.shape) != (device, torch.int32,
                                                       (1,)):
            step = step.to(device=device, dtype=torch.int32).reshape(1)
        group["step"] = step
        return step

    @staticmethod
    def _advance(step, flag):
        """JAX's ``step + where(noop > 0, 0, 1)``, on the device."""
        step.add_(torch.logical_not(flag.reshape(1) > 0).to(torch.int32))
