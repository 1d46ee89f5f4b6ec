"""``apex_tpu_torch.amp.functional``: amp O1's shim namespace over
``torch``, ``torch.nn.functional`` and ``torch.linalg``.

The port's counterpart of ``apex_tpu/amp/jnp.py`` (over ``jax.numpy``),
``apex_tpu/amp/nn.py`` (over ``jax.nn``) and ``apex_tpu/amp/lax.py``
(over ``jax.lax``), one module for the three, as torch keeps those
functions in ``torch`` and ``torch.nn.functional``. User code imports it
in place of the namespaces it wraps:

    from apex_tpu_torch.amp import functional as AF
    y = AF.matmul(x, w)          # bf16 while the amp policy is enabled
    p = AF.softmax(y, dim=-1)    # fp32 while it is enabled
    n = AF.linalg.norm(y)        # fp32 while it is enabled

and every function listed in :mod:`apex_tpu_torch.amp.lists` gets O1's
cast while the policy is enabled (``amp.initialize(..., opt_level="O1")``
or an ``amp.autocast()`` block): HALF functions in the compute dtype,
FLOAT functions in fp32, PROMOTE functions in the widest floating dtype
of their inputs. Unlisted functions and disabled-policy calls pass
through: a name not wrapped here is looked up in ``torch``, then in
``torch.nn.functional``.
"""

import torch as _torch
import torch.nn.functional as _F

from apex_tpu_torch.amp import lists as _lists
from apex_tpu_torch.amp.policy import (
    float_function,
    half_function,
    promote_function,
)

_SPACES = {"torch": _torch, "F": _F, "linalg": _torch.linalg}
_WRAPPERS = ((_lists.HALF, half_function), (_lists.FLOAT, float_function),
             (_lists.PROMOTE, promote_function))


def _wrapped(space):
    return {name: wrap(getattr(_SPACES[space], name))
            for names, wrap in _WRAPPERS for sp, name in names if sp == space}


class _Linalg:
    """``torch.linalg`` with the listed functions wrapped; the rest
    forwarded."""

    def __init__(self):
        self.__dict__.update(_wrapped("linalg"))

    def __getattr__(self, name):
        return getattr(_torch.linalg, name)


linalg = _Linalg()

_WRAPPED = {**_wrapped("torch"), **_wrapped("F")}
globals().update(_WRAPPED)


def __getattr__(name):  # PEP 562: the rest of torch, then of F
    if hasattr(_torch, name):
        return getattr(_torch, name)
    return getattr(_F, name)


def __dir__():
    return sorted(set(_WRAPPED) | {"linalg"})
