"""Dtype policy: amp O1's casts, explicit.

Counterpart of ``apex_tpu/amp/policy.py`` (reference apex/amp/
amp.py:30-183 and the cast lists of apex/amp/lists/). The reference
patches the torch namespaces at ``amp.init``; JAX's port cannot patch
what jit traces and keeps a policy instead, which its O1 shim namespaces
consult. This port follows JAX: a :class:`DtypePolicy` that the shim
(:mod:`apex_tpu_torch.amp.functional`) and user code (through the
decorators) consult at call time:

- compute ops (matmuls, convolutions; the ``HALF`` lists) run in
  ``compute_dtype`` (bf16 by default),
- reductions, transcendentals and losses (``FLOAT``) in fp32,
- multi-argument elementwise ops (``PROMOTE``) in the widest floating
  dtype of their inputs.

``torch.autocast`` is a different mechanism (a dispatcher-level cast of
every listed aten op) and is not used: as in JAX, casts happen only where
the policy is consulted, and none of the port's layers consults it.
"""

import contextlib
import functools
import logging
import threading

import torch


class DtypePolicy:
    def __init__(self, enabled=False, compute_dtype=torch.bfloat16,
                 cast_model_outputs=None):
        self.enabled = enabled
        self.compute_dtype = compute_dtype
        self.cast_model_outputs = cast_model_outputs

    def cast_to_compute(self, *args):
        if not self.enabled:
            return args if len(args) > 1 else args[0]
        out = tuple(_cast_tree(a, self.compute_dtype) for a in args)
        return out if len(out) > 1 else out[0]

    def cast_to_float(self, *args):
        if not self.enabled:
            return args if len(args) > 1 else args[0]
        out = tuple(_cast_tree(a, torch.float32) for a in args)
        return out if len(out) > 1 else out[0]


def _is_float_tensor(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast_tree(tree, dtype):
    """``tree`` (a tensor, or lists, tuples and dicts of them, nested)
    with every floating tensor cast to ``dtype``; anything else as it
    is."""
    if _is_float_tensor(tree):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    return tree


def _float_leaves(tree):
    if _is_float_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)


_local = threading.local()

# the process-global policy: amp.initialize(opt_level="O1") enables it
# (where the reference patches the namespaces, amp/_initialize.py:235-248);
# an autocast() block overrides it for its thread
_global_policy = DtypePolicy(enabled=False)


def set_global_policy(policy: DtypePolicy, verbosity: int = 0) -> None:
    """Install the process-global policy; with ``verbosity > 0`` a flip
    of its enabled state is logged."""
    global _global_policy
    if bool(policy.enabled) != bool(_global_policy.enabled) and verbosity > 0:
        logging.getLogger("apex_tpu_torch.amp").info(
            "amp: global dtype policy %s (compute dtype %s)",
            "enabled" if policy.enabled else "disabled", policy.compute_dtype)
    _global_policy = policy


def current_policy() -> DtypePolicy:
    return getattr(_local, "policy", None) or _global_policy


@contextlib.contextmanager
def autocast(enabled=True, dtype=torch.bfloat16):
    """Enable the compute-dtype policy (amp O1) in this thread inside the
    block."""
    prev = getattr(_local, "policy", None)
    _local.policy = DtypePolicy(enabled=enabled, compute_dtype=dtype)
    try:
        yield _local.policy
    finally:
        _local.policy = prev


# -- decorators (reference apex/amp/amp.py:30-70) ---------------------------

def half_function(fn):
    """Run ``fn`` with its floating tensor arguments cast to the compute
    dtype while the policy is enabled."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        pol = current_policy()
        if pol.enabled:
            args = _cast_tree(args, pol.compute_dtype)
            kwargs = _cast_tree(kwargs, pol.compute_dtype)
        return fn(*args, **kwargs)
    return wrapper


def float_function(fn):
    """Run ``fn`` in fp32 while the policy is enabled (loss-like ops)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if current_policy().enabled:
            args = _cast_tree(args, torch.float32)
            kwargs = _cast_tree(kwargs, torch.float32)
        return fn(*args, **kwargs)
    return wrapper


def promote_function(fn):
    """Run ``fn`` with its floating tensor arguments promoted to their
    widest dtype while the policy is enabled."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if current_policy().enabled:
            dtypes = [t.dtype for t in _float_leaves((args, kwargs))]
            if dtypes:
                widest = functools.reduce(torch.promote_types, dtypes)
                args = _cast_tree(args, widest)
                kwargs = _cast_tree(kwargs, widest)
        return fn(*args, **kwargs)
    return wrapper


# register_* replace an attribute of a module or object in place
# (reference amp.py:42-70)

def register_half_function(module, name):
    setattr(module, name, half_function(getattr(module, name)))


def register_float_function(module, name):
    setattr(module, name, float_function(getattr(module, name)))


def register_promote_function(module, name):
    setattr(module, name, promote_function(getattr(module, name)))
