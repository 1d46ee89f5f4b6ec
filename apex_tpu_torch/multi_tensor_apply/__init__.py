from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (  # noqa: F401
    MultiTensorApply,
    multi_tensor_applier,
)
