"""amp O1 cast lists for the shim namespace :mod:`apex_tpu_torch.amp.
functional`.

Counterpart of ``apex_tpu/amp/lists.py``, whose lists name ``jax.numpy``
(``JNP_*``), ``jax.nn`` (``NN_*``), ``jax.lax`` (``LAX_*``) and
``jax.numpy.linalg`` (``LINALG_FLOAT``) functions. Here each of those
names maps to its torch counterpart as ``"<namespace>:<name>"``, the
namespace ``torch``, ``F`` (``torch.nn.functional``) or ``linalg``
(``torch.linalg``); several names where one JAX function covers several
torch ones (``lax.conv_general_dilated``: ``conv1d``, ``conv2d``,
``conv3d``), or ``"none:<why>"`` where torch has no counterpart. The
mapping keeps JAX's class (HALF, FLOAT, PROMOTE) and its deliberate
deviations from the reference (``jax.nn.gelu`` in the compute dtype; the
reference runs gelu in fp32). Arguments keep torch's meaning: the shim
casts, it does not translate signatures (``torch.var`` is unbiased by
default, ``jnp.var`` is not; ``F.gelu`` is exact by default, ``jax.nn.
gelu`` the tanh approximation).

``HALF``, ``FLOAT`` and ``PROMOTE`` collect the torch names of each class
that the shim wraps.
"""

JNP_HALF = {
    "matmul": "torch:matmul", "dot": "torch:dot", "vdot": "torch:vdot",
    "inner": "torch:inner", "outer": "torch:outer",
    "tensordot": "torch:tensordot", "einsum": "torch:einsum",
    "kron": "torch:kron",
}

JNP_FLOAT = {
    "exp": "torch:exp", "expm1": "torch:expm1", "log": "torch:log",
    "log1p": "torch:log1p", "log2": "torch:log2", "log10": "torch:log10",
    "power": "torch:pow", "float_power": "torch:float_power",
    "prod": "torch:prod", "sum": "torch:sum", "cumprod": "torch:cumprod",
    "cumsum": "torch:cumsum", "mean": "torch:mean", "var": "torch:var",
    "std": "torch:std", "median": "torch:median",
    "reciprocal": "torch:reciprocal", "sinh": "torch:sinh",
    "cosh": "torch:cosh", "tan": "torch:tan", "arcsin": "torch:arcsin",
    "arccos": "torch:arccos", "arctan": "torch:arctan",
    "arcsinh": "torch:arcsinh", "arccosh": "torch:arccosh",
    "arctanh": "torch:arctanh", "nansum": "torch:nansum",
    "nanprod": "none:torch has no nanprod; torch.prod of "
               "torch.nan_to_num(x, nan=1.0) composes it from listed ops",
    "nanmean": "torch:nanmean", "trace": "torch:trace",
    "interp": "none:torch has no 1-D linear interpolation of sample "
              "points; F.interpolate resamples grids",
}

JNP_PROMOTE = {
    "add": "torch:add", "subtract": "torch:subtract",
    "multiply": "torch:multiply", "divide": "torch:divide",
    "true_divide": "torch:true_divide", "floor_divide": "torch:floor_divide",
    "remainder": "torch:remainder",
    "mod": "torch:remainder",  # jnp.mod is jnp.remainder (Python's sign)
    "concatenate": "torch:concatenate", "stack": "torch:stack",
    "hstack": "torch:hstack", "vstack": "torch:vstack",
    "dstack": "torch:dstack", "column_stack": "torch:column_stack",
    "where": "torch:where", "minimum": "torch:minimum",
    "maximum": "torch:maximum", "fmin": "torch:fmin", "fmax": "torch:fmax",
    "hypot": "torch:hypot", "heaviside": "torch:heaviside",
    "logaddexp": "torch:logaddexp", "logaddexp2": "torch:logaddexp2",
    "equal": "torch:eq",  # elementwise, as jnp.equal (torch.equal is not)
    "not_equal": "torch:ne", "less": "torch:less",
    "less_equal": "torch:less_equal", "greater": "torch:greater",
    "greater_equal": "torch:greater_equal", "allclose": "torch:allclose",
    "isclose": "torch:isclose", "arctan2": "torch:arctan2",
    "cross": "linalg:cross",  # the last axis, as jnp.cross (torch.cross
                              # takes the first of size 3)
    "array_equal": "torch:equal",
}

NN_HALF = {
    "relu": "F:relu", "gelu": "F:gelu", "silu": "F:silu",
    "swish": "F:silu", "glu": "F:glu", "leaky_relu": "F:leaky_relu",
    "elu": "F:elu", "celu": "F:celu", "selu": "F:selu",
    "hard_tanh": "F:hardtanh", "relu6": "F:relu6",
}

NN_FLOAT = {
    "softmax": "F:softmax", "log_softmax": "F:log_softmax",
    "logsumexp": "torch:logsumexp",
    "standardize": "none:torch has no one standardize call (F.normalize "
                   "divides by a p-norm); (x - mean) / sqrt(var + eps) "
                   "composes it from listed FLOAT ops",
    "softplus": "F:softplus", "sigmoid": "torch:sigmoid",
    "log_sigmoid": "F:logsigmoid",
    "one_hot": "F:one_hot",  # integer input: nothing to cast in torch
}

LAX_HALF = {
    "conv": ("F:conv1d", "F:conv2d", "F:conv3d"),
    "conv_with_general_padding": ("F:conv1d", "F:conv2d", "F:conv3d"),
    "conv_general_dilated": ("F:conv1d", "F:conv2d", "F:conv3d"),
    "conv_transpose": ("F:conv_transpose1d", "F:conv_transpose2d",
                       "F:conv_transpose3d"),
    "dot": "torch:matmul", "dot_general": "torch:tensordot",
    "batch_matmul": "torch:bmm",
}

LAX_FLOAT = {"rsqrt": "torch:rsqrt", "erf_inv": "torch:erfinv"}

LINALG_FLOAT = {name: f"linalg:{name}" for name in (
    "norm", "cond", "det", "slogdet", "eigvals", "eigvalsh", "svd", "qr",
    "cholesky", "inv", "pinv", "solve", "lstsq", "matrix_power",
    "matrix_rank")}


def torch_names(table):
    """The ``(namespace, name)`` pairs a table maps to, "none" entries
    left out."""
    out = []
    for target in table.values():
        for t in (target,) if isinstance(target, str) else target:
            space, name = t.split(":", 1)
            if space != "none":
                out.append((space, name))
    return out


HALF = sorted(set(torch_names(JNP_HALF) + torch_names(NN_HALF)
                  + torch_names(LAX_HALF)))
FLOAT = sorted(set(torch_names(JNP_FLOAT) + torch_names(NN_FLOAT)
                   + torch_names(LAX_FLOAT) + torch_names(LINALG_FLOAT)))
PROMOTE = sorted(set(torch_names(JNP_PROMOTE)))
