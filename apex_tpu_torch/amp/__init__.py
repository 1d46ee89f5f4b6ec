"""apex_tpu_torch.amp: automatic mixed precision.

Counterpart of ``apex_tpu/amp`` (reference apex/amp): ``initialize``
with the opt levels O0-O3 (bf16 where the reference has fp16), the
dynamic ``LossScaler`` whose state stays on the device, the
``AmpOptimizer`` that ``initialize`` wraps an optimizer in (unscale,
overflow skip and master weights in ``step()``, no host
synchronisation), ``scale_loss``, and O1's dtype policy with its
decorators and the shim namespace :mod:`apex_tpu_torch.amp.functional`.

    model = GPTModel(cfg)
    opt = FusedAdam(model.parameters(), lr=1e-4)
    model, opt = amp.initialize(model, opt, opt_level="O2")
    with amp.scale_loss(loss_fn(model(tokens)), opt) as scaled:
        scaled.backward()
    opt.step(); opt.zero_grad()
"""

from apex_tpu_torch.amp import functional, lists  # noqa: F401 (O1 shim)
from apex_tpu_torch.amp._amp_state import _amp_state, master_params
from apex_tpu_torch.amp.amp_optimizer import AmpOptimizer
from apex_tpu_torch.amp.frontend import (
    O0,
    O1,
    O2,
    O3,
    Properties,
    cast_model,
    initialize,
    load_state_dict,
    state_dict,
)
from apex_tpu_torch.amp.handle import disable_casts, scale_loss
from apex_tpu_torch.amp.policy import (
    DtypePolicy,
    autocast,
    current_policy,
    float_function,
    half_function,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
    set_global_policy,
)
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState

__all__ = [
    "AmpOptimizer", "DtypePolicy", "LossScaler", "O0", "O1", "O2", "O3",
    "Properties", "ScalerState", "_amp_state", "autocast", "cast_model",
    "current_policy", "disable_casts", "float_function", "functional",
    "half_function", "initialize", "lists", "load_state_dict",
    "master_params", "promote_function", "register_float_function",
    "register_half_function", "register_promote_function", "scale_loss",
    "set_global_policy", "state_dict",
]
