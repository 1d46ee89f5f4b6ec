"""Multi-tensor fused optimizer ops (the Adam part of Apex's ``amp_C``).

Counterpart of ``apex_tpu/ops/multi_tensor.py`` ``multi_tensor_adam``.
The JAX op is a functional loop over the tensors that XLA fuses; eager
PyTorch has no such fusion, so here the update runs in the multi-tensor
CUDA kernel of :mod:`apex_tpu_torch.kernels.optim` (a launch per 64
tensors) and updates the tensors **in place**, as the reference's
``multi_tensor_adam`` does. CPU tensors take the kernel's plain version.
The other ops of the JAX module (scale, axpby, l2norm, SGD, LAMB, ...)
come with the slices that use them.
"""

import torch

from apex_tpu_torch.kernels import optim as _kernels


def bias_corrections(beta1, beta2, step):
    """``(1 - beta1**step, 1 - beta2**step)`` as jnp computes them from
    an int32 step: the power of the fp32-rounded beta, rounded to fp32,
    subtracted from 1 in fp32; returned as Python floats holding those
    fp32 values. XLA's fp32 power is (nearly always) the correctly
    rounded one, which a double power rounded once gives; torch's fp32
    ``pow`` is an ulp off on some steps, and so is a subtraction in
    float64."""
    out = []
    for beta in (beta1, beta2):
        b = torch.tensor(beta, dtype=torch.float32).item()
        power = torch.tensor(b ** int(step), dtype=torch.float32)
        out.append((1.0 - power).item())
    return tuple(out)


def multi_tensor_adam(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                      mode, bias_correction, weight_decay):
    """Fused Adam (``mode`` 0: L2 regularisation) or AdamW (``mode`` 1:
    decoupled weight decay) over ``tensor_lists = [grads, params,
    exp_avgs, exp_avg_sqs]``, updating params, exp_avgs and exp_avg_sqs
    in place. Nothing changes where ``noop_flag`` (a one-element fp32
    tensor on the tensors' device) is non-zero. ``step`` is the step
    count after this update (1 on the first)."""
    grads, params, exp_avgs, exp_avg_sqs = tensor_lists
    if mode not in (0, 1):
        raise ValueError(f"multi_tensor_adam: mode must be 0 or 1, got {mode}")
    if bias_correction:
        bc1, bc2 = bias_corrections(beta1, beta2, step)
    else:
        bc1 = bc2 = 1.0
    # L2 decay of 0 adds nothing: the JAX op skips it, the kernel adds 0*p
    _kernels.adam(noop_flag, grads, params, exp_avgs, exp_avg_sqs, lr=lr,
                  bc1=bc1, bc2=bc2, b1=beta1, b2=beta2, eps=eps,
                  weight_decay=weight_decay, adam_w=(mode == 1))
