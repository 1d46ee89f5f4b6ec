"""The legacy manual mixed-precision helpers: fp32 master weights with
``FP16_Optimizer``, the model and master conversions of ``fp16util``
and the host loss scalers.

Counterpart of ``apex_tpu/fp16_utils`` (reference ``apex/fp16_utils``),
with its exports.
"""

from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.fp16_utils.fp16util import (
    BN_convert_float,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
)
from apex_tpu_torch.fp16_utils.loss_scaler import DynamicLossScaler, LossScaler

__all__ = ["BN_convert_float", "DynamicLossScaler", "FP16_Optimizer",
           "LossScaler", "convert_network", "master_params_to_model_params",
           "model_grads_to_master_grads", "network_to_half",
           "prep_param_lists", "to_python_float"]
