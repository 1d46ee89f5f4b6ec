"""Autocast helpers for custom autograd functions.

Counterpart of ``apex_tpu/_autocast_utils.py`` (reference
apex/_autocast_utils.py: ``_get_autocast_dtypes`` 9-12,
``_cast_if_autocast_enabled`` 22-26). The ambient context they consult
is amp's O1 state (:mod:`apex_tpu_torch.amp`), as JAX's consults its
own; ``torch.autocast`` is not consulted.
"""

from typing import Sequence

import torch

from apex_tpu_torch.amp._amp_state import _amp_state


def _get_autocast_dtypes() -> Sequence:
    """The dtypes an autocast region may produce."""
    return [torch.bfloat16, torch.float16, torch.float32]


def _get_current_dtype(dtype=None):
    """``dtype`` when given, else amp's cast dtype while amp is enabled
    (bf16 where the opt level casts none), else fp32."""
    if dtype is not None:
        return dtype
    props = getattr(_amp_state, "opt_properties", None)
    if props is not None and getattr(props, "enabled", False):
        return getattr(props, "cast_model_type", None) or torch.bfloat16
    return torch.float32


def _cast_if_autocast_enabled(*args):
    """``args`` with their floating tensors cast to :func:`_get_current_dtype`
    while amp's O1 casts are enabled; as they are otherwise."""
    props = getattr(_amp_state, "opt_properties", None)
    if props is None or not getattr(props, "patch_torch_functions", False):
        return args
    target = _get_current_dtype()
    return tuple(a.to(target) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)
