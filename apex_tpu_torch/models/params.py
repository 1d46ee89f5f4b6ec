"""Parameters of :class:`apex_tpu_torch.models.GPTModel` and
:class:`~apex_tpu_torch.models.BertModel`: carried over from the JAX
package's flax tree, or drawn from a seed; and the state of the JAX
``FusedAdam`` or ``FusedLAMB`` carried into the port's optimizer.

The port keeps the JAX package's parameter names and layouts, so the
flax tree of ``apex_tpu.models.GPTModel`` (Llama- or GPT-2-shaped) or
``apex_tpu.models.BertModel`` maps one to one onto the port's
``state_dict``: nested keys joined with ".", and the flax layer scopes
``layer_<i>`` become the entries ``layers.<i>`` of the module list
(BERT's flax ``Dense`` heads keep their ``kernel`` and ``bias``).
"""

import re

import numpy as np
import torch

_LAYER = re.compile(r"^transformer\.layer_(\d+)\.")


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def from_jax_params(tree, config=None):
    """The port's ``state_dict`` from a flax ``params`` tree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``). ``config``
    (a port :class:`TransformerConfig`) checks that the tree's depth
    matches it."""
    state = {_LAYER.sub(r"transformer.layers.\1.", name):
             torch.from_numpy(np.array(value, copy=True))
             for name, value in _flatten(tree)}
    if config is not None:
        layers = {int(m.group(1)) for name in state
                  if (m := re.match(r"transformer\.layers\.(\d+)\.", name))}
        if len(layers) != config.num_layers:
            raise ValueError(f"tree has {len(layers)} layers, config "
                             f"{config.num_layers}")
    return state


@torch.no_grad()
def load_jax_optimizer_state(optimizer, model, state):
    """Carry the JAX ``FusedAdam`` or ``FusedLAMB`` state of ``model``'s
    parameters into the port's ``optimizer`` (a
    :class:`apex_tpu_torch.optimizers.FusedAdam` or ``FusedLAMB`` over
    ``model.parameters()``, in one group). ``state`` is the JAX
    optimizer's ``{"step", "exp_avg", "exp_avg_sq"}`` (both optimizers
    keep these) with numpy leaves (``jax.tree.map(np.asarray,
    opt_state)``): each buffer goes to the parameter of the same name,
    and the group's step count becomes ``step``."""
    fn = "load_jax_optimizer_state"
    if len(optimizer.param_groups) != 1:
        raise ValueError(f"{fn}: the optimizer must hold one parameter "
                         f"group")
    params = dict(model.named_parameters())
    for name in ("exp_avg", "exp_avg_sq"):
        tree = from_jax_params(state[name])
        if tree.keys() != params.keys():
            raise ValueError(f"{fn}: {name} names "
                             f"{sorted(tree.keys() ^ params.keys())} do not "
                             f"match the model's parameters")
        for key, value in tree.items():
            p = params[key]
            if value.shape != p.shape:
                raise ValueError(f"{fn}: {name} of {key} has shape "
                                 f"{tuple(value.shape)}, the parameter "
                                 f"{tuple(p.shape)}")
            optimizer.state[p][name] = value.to(device=p.device,
                                                dtype=torch.float32)
    optimizer.param_groups[0]["step"] = int(state["step"])



# drawn ~ N(0, 0.02), as the JAX package's initialisers draw them
_NORMAL_002 = ("word_embeddings.weight", "position_embeddings",
               "tokentype_embeddings", "lm_head")


@torch.no_grad()
def init_weights(model, seed: int):
    """Random weights from ``seed``, drawn on the model's device: matrices
    ~ N(0, 1/fan_in) (flax's lecun_normal scale, untruncated), the
    embeddings (word, position, token type) and the LM head ~ N(0, 0.02)
    as the JAX package initialises them, norm weights 1, biases 0."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        elif name in _NORMAL_002:
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
