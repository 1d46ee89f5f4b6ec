"""Parameters of :class:`apex_tpu_torch.models.GPTModel`,
:class:`~apex_tpu_torch.models.BertModel` and
:class:`~apex_tpu_torch.models.DeepseekModel`: carried over from the JAX
package's flax tree, or drawn from a seed; and the state of the JAX
fused optimizers (and of ``FP16_Optimizer``) carried into the port's.

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


def from_jax_name(name):
    """The port's name of a JAX parameter path (dotted): the flax layer
    scope ``layer_<i>`` becomes ``layers.<i>``."""
    return _LAYER.sub(r"\1layers.\2.", name)


def from_jax_params(tree, config=None):
    """The port's ``state_dict`` from a flax ``params`` tree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``): of a
    ``GPTModel`` or ``BertModel`` (layer scopes ``transformer.layer_<i>``)
    or of a ``DeepseekModel`` (``layer_<i>``). ``config`` (the port's
    :class:`TransformerConfig` or :class:`MLAConfig`) checks that the
    tree's depth matches it."""
    state = {from_jax_name(name): torch.from_numpy(np.array(value,
                                                           copy=True))
             for name, value in _flatten(tree)}
    if config is not None:
        layers = {int(m.group(2)) for name in state
                  if (m := _PORT_LAYER.match(name))}
        if len(layers) != config.num_layers:
            raise ValueError(f"tree has {len(layers)} layers, config "
                             f"{config.num_layers}")
    return state


def rank_state_dict(stacked, rank: int):
    """Rank ``rank``'s ``state_dict`` from a stacked ``[tp, ...]`` tree,
    each leaf's index ``rank`` along its first axis: the port's
    (:func:`~apex_tpu_torch.models.tp_split.split_params_for_tp`,
    :func:`~apex_tpu_torch.models.generation.init_params_tp`, ``{name:
    tensor}``) or the JAX package's (its ``split_params_for_tp`` or
    ``init_params_tp`` tree with numpy leaves, named as
    :func:`from_jax_params` names it). Each value is a copy."""
    if any(isinstance(v, dict) or hasattr(v, "items")
           for v in stacked.values()):
        stacked = from_jax_params(stacked)
    out = {}
    for name, value in stacked.items():
        value = torch.as_tensor(value)
        if not 0 <= int(rank) < value.shape[0]:
            raise ValueError(f"rank_state_dict: {name} stacks "
                             f"{value.shape[0]} ranks, not rank {rank}")
        out[name] = value[int(rank)].clone()
    return out


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


def _leaf_names(tree, prefix=""):
    """The dotted names of ``tree``'s leaves in JAX's ``tree_flatten``
    order (each dict's keys sorted), JAX's layer scopes kept."""
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaf_names(value, name + ".")
        else:
            yield name


def _carry_tree(fn, what, tree, targets):
    """``{target tensor: tensor}`` for a JAX per-parameter tree (numpy
    leaves) whose names must be ``targets``' ({port name: tensor}), each
    value of its target's shape."""
    values = from_jax_params(tree)
    if values.keys() != targets.keys():
        raise ValueError(f"{fn}: {what} names "
                         f"{sorted(values.keys() ^ targets.keys())} do not "
                         f"match the model's parameters")
    out = {}
    for key, value in values.items():
        t = targets[key]
        if value.shape != t.shape:
            raise ValueError(f"{fn}: {what} of {key} has shape "
                             f"{tuple(value.shape)}, the parameter "
                             f"{tuple(t.shape)}")
        out[key] = value.to(device=t.device, dtype=torch.float32)
    return out


@torch.no_grad()
def load_jax_optimizer_state(optimizer, model, state):
    """Carry the JAX optimizer state of ``model``'s parameters into the
    port's ``optimizer`` (over ``model.parameters()``, in one group).
    ``state`` has numpy leaves (``jax.tree.map(np.asarray, opt_state)``)
    and is that of

    - ``FusedAdam`` or ``FusedLAMB``: ``{"step", "exp_avg",
      "exp_avg_sq"}``;
    - ``FusedAdagrad``: ``{"step", "sum"}``;
    - ``FusedNovoGrad``: ``{"step", "exp_avg", "exp_avg_sq"}``, its
      ``exp_avg_sq`` one value a parameter in JAX's ``tree_flatten`` leaf
      order (each dict's keys sorted), which goes to the group's vector in
      the port's parameter order, matched by leaf path;
    - ``FP16_Optimizer`` over any of these (its ``optimizer`` here): the
      inner state plus ``"fp32_master"``, copied into the wrapper's fp32
      masters, which the inner state then belongs to.

    Each per-parameter tree goes to the parameter (or master) of the same
    name, and the group's step count becomes ``step``."""
    fn = "load_jax_optimizer_state"
    inner = getattr(optimizer, "inner", optimizer)
    if len(inner.param_groups) != 1:
        raise ValueError(f"{fn}: the optimizer must hold one parameter "
                         f"group")
    named = dict(model.named_parameters())
    if "fp32_master" in state:
        master_of = {id(p): m for p, m in zip(optimizer.model_params,
                                              optimizer.masters)}
        targets = {name: master_of[id(p)] for name, p in named.items()}
        for key, value in _carry_tree(fn, "fp32_master",
                                      state["fp32_master"], targets).items():
            targets[key].copy_(value)
    else:
        targets = named
    group = inner.param_groups[0]
    for name, tree in state.items():
        if name in ("step", "fp32_master"):
            continue
        if isinstance(tree, dict) or hasattr(tree, "items"):
            for key, value in _carry_tree(fn, name, tree, targets).items():
                inner.state[targets[key]][name] = value
            continue
        # one value a parameter, in JAX's leaf order (NovoGrad's
        # exp_avg_sq): matched by the leaf paths of the per-parameter tree
        order = [from_jax_name(n) for n in _leaf_names(state["exp_avg"])]
        at = {n: k for k, n in enumerate(order)}
        name_of = {id(t): n for n, t in targets.items()}
        values = torch.from_numpy(np.array(tree, dtype=np.float32))
        if set(at) != set(targets) or values.shape != (len(order),):
            raise ValueError(f"{fn}: {name} holds {tuple(values.shape)} "
                             f"values for {len(targets)} parameters")
        group[name] = values[[at[name_of[id(t)]] for t in group["params"]]
                             ].to(group["params"][0].device)
    group["step"] = int(state["step"])


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
