"""Parameters of :class:`apex_tpu_torch.models.GPTModel`,
:class:`~apex_tpu_torch.models.BertModel` and
:class:`~apex_tpu_torch.models.DeepseekModel`: carried over from the JAX
package's flax tree, or drawn from a seed; and the state of the JAX
``FusedAdam`` or ``FusedLAMB`` carried into the port's optimizer.

The port keeps the JAX package's parameter names and layouts, so the
flax tree of ``apex_tpu.models.GPTModel`` (Llama- or GPT-2-shaped),
``apex_tpu.models.BertModel`` or ``apex_tpu.models.mla.DeepseekModel``
maps one to one onto the port's ``state_dict``: nested keys joined with
".", and the flax layer scopes ``layer_<i>`` become the entries
``layers.<i>`` of the module list (flax ``Dense`` layers keep their
``kernel`` and ``bias``: BERT's heads, MLA's ``q_a`` and ``kv_a``).
"""

import re

import numpy as np
import torch

_LAYER = re.compile(r"^(transformer\.)?layer_(\d+)\.")
_PORT_LAYER = re.compile(r"^(transformer\.)?layers\.(\d+)\.")


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def from_jax_params(tree, config=None):
    """The port's ``state_dict`` from a flax ``params`` tree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``): of a
    ``GPTModel`` or ``BertModel`` (layer scopes ``transformer.layer_<i>``)
    or of a ``DeepseekModel`` (``layer_<i>``). ``config`` (the port's
    :class:`TransformerConfig` or :class:`MLAConfig`) checks that the
    tree's depth matches it."""
    state = {_LAYER.sub(r"\1layers.\2.", name):
             torch.from_numpy(np.array(value, copy=True))
             for name, value in _flatten(tree)}
    if config is not None:
        layers = {int(m.group(2)) for name in state
                  if (m := _PORT_LAYER.match(name))}
        if len(layers) != config.num_layers:
            raise ValueError(f"tree has {len(layers)} layers, config "
                             f"{config.num_layers}")
    return state


def from_jax_segments(segments):
    """The port's mesh2d segment tuple
    (:func:`apex_tpu_torch.parallel.mesh2d.gpt2_init`'s layout) from
    ``apex_tpu.parallel.mesh2d``'s, whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, seg_params)``): the same nested dicts of
    CPU tensors, as :func:`from_jax_params` gives them."""
    def carry(tree):
        return {k: carry(v) if isinstance(v, dict) or hasattr(v, "items")
                else torch.from_numpy(np.array(v, copy=True))
                for k, v in tree.items()}

    return tuple(carry(seg) for seg in segments)


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
               "tokentype_embeddings", "lm_head", "embed_tokens.weight")


@torch.no_grad()
def init_weights(model, seed: int):
    """Random weights from ``seed``, drawn on the model's device in the
    parameters' dtype: matrices ~ N(0, 1/fan_in) (flax's lecun_normal
    scale, untruncated; a stack of expert matrices [E, in, out] per
    expert), the embeddings (word, position, token type) and the LM head
    ~ N(0, 0.02) as the JAX package initialises them, norm weights 1,
    biases 0."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        elif name in _NORMAL_002:
            p.normal_(0.0, 0.02, generator=gen)
        else:
            fan_in = p.shape[-2] if p.dim() > 1 else p.shape[0]
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
