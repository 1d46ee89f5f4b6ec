"""The legacy model and master-weight conversions.

Counterpart of ``apex_tpu/fp16_utils/fp16util.py`` (reference
``apex/fp16_utils/fp16util.py``). JAX's helpers take a parameter tree
and return new trees or lists; these take modules and parameter lists,
in PyTorch's idiom, and write in place where reference Apex does (each
docstring says so). bf16 is the default half type; the norm layers'
parameters stay fp32 by the same names as JAX's ``_is_norm_path``
(:func:`apex_tpu_torch.amp.frontend.is_norm_name`).
"""

import torch

from apex_tpu_torch.amp.frontend import cast_model, is_norm_name
from apex_tpu_torch.optimizers._base import master_copy


def network_to_half(network, dtype=torch.bfloat16):
    """:func:`convert_network` to ``dtype`` (bf16 by default): every
    floating parameter cast, the norm layers' kept fp32. In place (each
    ``Parameter`` object kept); returns ``network``."""
    return convert_network(network, dtype)


@torch.no_grad()
def BN_convert_float(network):
    """The norm layers' floating parameters back to fp32, in place;
    returns ``network``."""
    for name, p in network.named_parameters():
        if p.is_floating_point() and is_norm_name(name):
            p.data = p.data.float()
    return network


def convert_network(network, dtype):
    """Every floating parameter of ``network`` cast to ``dtype`` but the
    norm layers', which become fp32 (JAX's ``convert_network``). In place
    (``p.data``; buffers as they are, as JAX casts its parameter tree
    only); returns ``network``."""
    return cast_model(network, dtype, keep_batchnorm_fp32=True)


def _params(model):
    if isinstance(model, torch.nn.Module):
        return [p for p in model.parameters() if p.requires_grad]
    return list(model)


def prep_param_lists(model, flat_master=False):
    """``(model_params, master_params)``: the parameters of ``model`` (a
    module: those that require a gradient; or a list) and fp32 masters of
    them, each a leaf that requires a gradient and never aliases its
    parameter; with ``flat_master``, one master, the parameters
    flattened and concatenated in order."""
    model_params = _params(model)
    with torch.no_grad():
        if flat_master:
            masters = [torch.cat([p.reshape(-1).float()
                                  for p in model_params])]
        else:
            masters = [master_copy(p) for p in model_params]
    for m in masters:
        m.requires_grad_(True)
    return model_params, masters


@torch.no_grad()
def model_grads_to_master_grads(model_params, master_params,
                                flat_master=False):
    """Each model gradient into its master's ``.grad`` in fp32, in place
    (JAX returns the list of them): a master's ``.grad`` is made where it
    has none, and set to None where its parameter has none; with
    ``flat_master`` the gradients, flattened and concatenated, go into the
    one master's. Returns the master gradients."""
    if flat_master:
        master = master_params[0]
        flat = torch.cat([p.grad.reshape(-1).float() for p in model_params])
        if master.grad is None:
            master.grad = flat
        else:
            master.grad.copy_(flat)
        return [master.grad]
    for p, m in zip(model_params, master_params):
        if p.grad is None:
            m.grad = None
        elif m.grad is None:
            m.grad = p.grad.float().clone()
        else:
            m.grad.copy_(p.grad)
    return [m.grad for m in master_params]


@torch.no_grad()
def master_params_to_model_params(model_params, master_params,
                                  flat_master=False):
    """Each master into its parameter, rounded to the parameter's dtype,
    in place (JAX returns the new parameters); with ``flat_master`` the
    one master's consecutive slices, in order. Returns ``model_params``."""
    if flat_master:
        flat, at = master_params[0], 0
        for p in model_params:
            p.copy_(flat[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return model_params
    for p, m in zip(model_params, master_params):
        p.copy_(m)
    return model_params


def to_python_float(t):
    """A number from a tensor of one element (``.item()``) or a number."""
    if hasattr(t, "item"):
        return t.item()
    return float(t)
