"""amp's front end: the opt-level properties and ``initialize``.

Counterpart of ``apex_tpu/amp/frontend.py`` (reference apex/amp/
frontend.py: ``Properties`` 9-99, ``O0``-``O3`` 104-193, ``initialize``
197-362, ``state_dict``/``load_state_dict`` 365-404), with fp16 as bf16:

  O0: pure fp32 (no casts, loss scale 1).
  O1: parameters fp32; the dtype policy enabled, which the O1 shim
      (:mod:`apex_tpu_torch.amp.functional`) and the decorators consult;
      dynamic loss scale.
  O2: parameters cast to bf16 except the norm layers'; fp32 master
      weights stepped by the wrapped optimizer; dynamic loss scale.
  O3: pure bf16, no masters, loss scale 1.

A model is an ``nn.Module``: ``initialize`` casts its parameters in
place (``p.data``), so an optimizer built on ``model.parameters()``
before it keeps stepping the same ``Parameter`` objects, and wraps each
optimizer in an :class:`~apex_tpu_torch.amp.AmpOptimizer` whose masters
are copies of the already cast parameters, as JAX's ``init`` copies them
from its cast tree.

Where an opt level computes in bf16 (O1's shim, O2 and O3's cast
models), ``initialize`` also makes each bf16 GEMM round its result once
from an fp32 sum, as JAX's ``matmul(..., preferred_element_type=f32)
.astype(bf16)`` does: it turns off cuBLAS's bf16 reduced-precision
reduction (``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction``, on in PyTorch by default),
under which a split-K GEMM rounds its partial sums to bf16. The setting
is the process's, as the reference's O1 patches the process's torch
functions; it stays after ``initialize``.
"""

import torch

from apex_tpu_torch.amp._amp_state import _amp_state, maybe_print
from apex_tpu_torch.amp.amp_optimizer import AmpOptimizer
from apex_tpu_torch.amp.scaler import LossScaler


class Properties:
    """Mutable option bundle (reference frontend.py:9-99)."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "patch_torch_functions": False,  # here: enable the dtype policy
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
        }

    def _update_options_dict(self, new_options):
        for k, v in new_options.items():
            if k in self.options:
                self.options[k] = v
            else:
                raise ValueError(f"Tried to set unexpected option {k}")

    def __getattr__(self, name):
        if "options" in self.__dict__ and name in self.__dict__["options"]:
            return self.options[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if "options" in self.__dict__ and name in self.options:
            self.options[name] = value
        else:
            super().__setattr__(name, value)


class O3:
    brief = "O3: Pure (b)f16 training."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = torch.bfloat16
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O2:
    brief = "O2: (b)f16 model with fp32 master weights."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = torch.bfloat16
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        return properties


class O1:
    brief = "O1: Insert automatic casts around compute ops (dtype policy)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O1"
        properties.cast_model_type = None
        properties.patch_torch_functions = True
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = None
        properties.loss_scale = "dynamic"
        return properties


class O0:
    brief = "O0: Pure fp32 training."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = torch.float32
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


opt_levels = {"O3": O3(), "O2": O2(), "O1": O1(), "O0": O0()}

# JAX's _is_norm_path markers (apex_tpu/amp/frontend.py:117-123)
_BN_MARKERS = ("batchnorm", "batch_norm", "bn", "norm")


def is_norm_name(name: str) -> bool:
    """Whether a parameter of this dotted name stays fp32 under
    ``keep_batchnorm_fp32``: JAX's ``_is_norm_path``, a marker as a
    substring of some part of the path. The port's parameter names are
    JAX's flax paths joined with "." (``models.params.from_jax_params``;
    ``layer_<i>`` is ``layers.<i>``, which holds no marker), so the two
    keep the same parameters fp32."""
    return any(m in part.lower() for part in name.split(".")
               for m in _BN_MARKERS)


@torch.no_grad()
def cast_model(model, dtype, keep_batchnorm_fp32=False):
    """Cast ``model``'s floating parameters to ``dtype`` in place (each
    ``Parameter`` object kept), the norm layers' to fp32 with
    ``keep_batchnorm_fp32`` (reference fp16util.convert_network, apex/amp/
    _initialize.py:178-184). Buffers are left as they are, as JAX casts
    only its parameter tree. Returns ``model``."""
    for name, p in model.named_parameters():
        if not p.is_floating_point():
            continue
        want = (torch.float32 if keep_batchnorm_fp32 and is_norm_name(name)
                else dtype)
        if p.dtype != want:
            p.data = p.data.to(want)
    return model


def _device_of(models):
    for m in models:
        for p in m.parameters():
            return p.device
    return None


def initialize(models, optimizers=None, enabled=True, opt_level="O1",
               cast_model_type=None, patch_torch_functions=None,
               keep_batchnorm_fp32=None, master_weights=None, loss_scale=None,
               cast_model_outputs=None, num_losses=1, verbosity=1,
               min_loss_scale=None, max_loss_scale=2.0 ** 24):
    """Initialize amp (reference frontend.py:197-362).

    ``models``: an ``nn.Module`` (or a list), cast in place per the opt
    level; ``optimizers``: one of the port's fused optimizers built on its
    parameters (or a list), each wrapped in an :class:`AmpOptimizer`.
    Returns ``(models, optimizers)`` in the forms given. The loss scalers'
    state lives on the models' device."""
    from apex_tpu_torch.amp import policy as _policy

    _amp_state.verbosity = verbosity
    if not enabled:
        # an O1 policy armed before must not leak into a disabled run
        _policy.set_global_policy(_policy.DtypePolicy(enabled=False),
                                  verbosity=verbosity)
        return models, optimizers
    if opt_level not in opt_levels:
        raise RuntimeError(f"Unexpected optimization level {opt_level}")

    _amp_state.opt_properties = opt_levels[opt_level](Properties())
    maybe_print(f"Selected optimization level {opt_levels[opt_level].brief}")
    for k, v in {"cast_model_type": cast_model_type,
                 "patch_torch_functions": patch_torch_functions,
                 "keep_batchnorm_fp32": keep_batchnorm_fp32,
                 "master_weights": master_weights,
                 "loss_scale": loss_scale}.items():
        if v is not None:
            setattr(_amp_state.opt_properties, k, v)
    props = _amp_state.opt_properties

    _policy.set_global_policy(_policy.DtypePolicy(
        enabled=bool(props.patch_torch_functions),
        compute_dtype=torch.bfloat16, cast_model_outputs=cast_model_outputs),
        verbosity=verbosity)
    if props.patch_torch_functions or props.cast_model_type == torch.bfloat16:
        # bf16 GEMMs rounded once from fp32 sums: no bf16 split-K
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)

    models_list = models if isinstance(models, list) else [models]
    if (props.cast_model_type is not None
            and props.cast_model_type != torch.float32):
        for m in models_list:
            cast_model(m, props.cast_model_type,
                       keep_batchnorm_fp32=bool(props.keep_batchnorm_fp32))

    device = _device_of(models_list)
    _amp_state.loss_scalers = [
        LossScaler(props.loss_scale, min_loss_scale=min_loss_scale,
                   max_loss_scale=max_loss_scale, device=device)
        for _ in range(num_losses)]

    out_optimizers = optimizers
    if optimizers is not None:
        opt_list = optimizers if isinstance(optimizers, list) else [optimizers]
        wrapped = [
            AmpOptimizer(opt, _amp_state.loss_scalers[min(i, num_losses - 1)],
                         master_weights=bool(props.master_weights),
                         model_dtype=props.cast_model_type)
            for i, opt in enumerate(opt_list)]
        _amp_state.optimizers = wrapped
        out_optimizers = wrapped if isinstance(optimizers, list) else wrapped[0]
    return models, out_optimizers


def state_dict(destination=None):
    """Every loss scaler's state (reference frontend.py:365-381)."""
    if destination is None:
        destination = {}
    for idx, ls in enumerate(_amp_state.loss_scalers):
        destination[f"loss_scaler{idx}"] = ls.state_dict()
    return destination


def load_state_dict(state_dict):
    """Restore the loss scalers (reference frontend.py:384-404)."""
    if len(state_dict) != len(_amp_state.loss_scalers):
        import warnings

        warnings.warn(f"Found {len(state_dict)} loss scalers in state_dict, "
                      f"expected {len(_amp_state.loss_scalers)}")
    for idx, ls in enumerate(_amp_state.loss_scalers):
        key = f"loss_scaler{idx}"
        if key in state_dict:
            ls.load_state_dict(state_dict[key])
