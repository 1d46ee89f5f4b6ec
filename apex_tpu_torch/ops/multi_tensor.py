"""Multi-tensor fused optimizer ops (the Adam, LAMB and L2-norm part of
Apex's ``amp_C``).

Counterpart of ``apex_tpu/ops/multi_tensor.py`` ``multi_tensor_adam``,
``multi_tensor_lamb`` and ``multi_tensor_l2norm``. The JAX ops are
functional loops over the tensors that XLA fuses; eager PyTorch has no
such fusion, so here the elementwise updates run in the multi-tensor
CUDA kernels of :mod:`apex_tpu_torch.kernels.optim` (a launch per 64
tensors) and update the tensors **in place**, as the reference's ops
do. CPU tensors take the kernels' plain versions. The norms and LAMB's
trust ratio have no TPU kernel and stay PyTorch (``torch._foreach_norm``).
The other ops of the JAX module (scale, axpby, SGD, ...) come with the
slices that use them.
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


def multi_tensor_l2norm(noop_flag, tensor_lists, per_tensor=False):
    """``(global L2 norm, per-tensor norms or None)`` over
    ``tensor_lists = [xs]``, in fp32 on the tensors' device (no host
    synchronisation)."""
    (xs,) = tensor_lists
    if not xs:
        return torch.zeros((), dtype=torch.float32,
                           device=noop_flag.device), None
    per = torch.stack(torch._foreach_norm([x.float() for x in xs]))
    total = torch.linalg.vector_norm(per)
    return total, (per if per_tensor else None)


def multi_tensor_lamb(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                      bias_correction, weight_decay, grad_averaging, mode,
                      global_grad_norm, max_grad_norm, use_nvlamb=False):
    """Fused LAMB over ``tensor_lists = [grads, params, exp_avgs,
    exp_avg_sqs]`` of fp32 tensors, updating params, exp_avgs and
    exp_avg_sqs in place; each grad is left holding its tensor's raw
    update (the reference's stage 1 stores it there). Nothing changes
    in params, exp_avgs, exp_avg_sqs or grads where ``noop_flag`` (a
    one-element fp32 tensor on the tensors' device) is non-zero.

    The gradients are divided by ``max(global_grad_norm / max_grad_norm,
    1)`` (when ``max_grad_norm`` > 0); ``mode`` 0 adds L2 decay to them,
    ``mode`` 1 adds decoupled decay to the update; the kernel writes the
    moments and the update. Then, as in JAX, each parameter moves by
    ``lr * ratio * update``, where the trust ratio is ||p|| / ||update||
    when both are > 0 (else 1) and applies when ``weight_decay`` != 0 or
    ``use_nvlamb``. ``step`` is the step count after this update."""
    grads, params, exp_avgs, exp_avg_sqs = tensor_lists
    if mode not in (0, 1):
        raise ValueError(f"multi_tensor_lamb: mode must be 0 or 1, got {mode}")
    if not params:
        return
    if bias_correction:
        bc1, bc2 = bias_corrections(beta1, beta2, step)
    else:
        bc1 = bc2 = 1.0
    clip = None
    if max_grad_norm is not None and max_grad_norm > 0:
        gnorm = torch.as_tensor(global_grad_norm, dtype=torch.float32,
                                device=noop_flag.device)
        clip = torch.clamp(gnorm / max_grad_norm, min=1.0).reshape(1)
    _kernels.lamb(noop_flag, grads, params, exp_avgs, exp_avg_sqs, clip=clip,
                  bc1=bc1, bc2=bc2, b1=beta1, b2=beta2,
                  beta3=(1 - beta1) if grad_averaging else 1.0, eps=eps,
                  weight_decay=weight_decay, adam_w=(mode == 1))
    updates = grads
    if weight_decay != 0 or use_nvlamb:
        w_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(updates))
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, 1.0)
        factors = (lr * ratio).unbind(0)
    else:
        factors = [lr] * len(params)
    skip = noop_flag.reshape(()) > 0
    with torch.no_grad():
        for p, u, f in zip(params, updates, factors):
            # where, not a factor of 0: a skipped step's g may hold inf
            p.sub_(torch.where(skip, 0.0, f * u))
