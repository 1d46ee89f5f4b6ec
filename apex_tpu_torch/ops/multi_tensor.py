"""Multi-tensor fused optimizer ops (Apex's ``amp_C``: scale, axpby,
the L2 norms, SGD, Adam, Adagrad, NovoGrad and LAMB, fused and in its
two public stages).

Counterpart of ``apex_tpu/ops/multi_tensor.py``. The JAX ops are
functional loops over the tensors that XLA fuses; eager PyTorch has no
such fusion, so here the elementwise updates run in the multi-tensor
CUDA kernels of :mod:`apex_tpu_torch.kernels.optim` and
:mod:`apex_tpu_torch.kernels.scale` (a launch per 64 tensors of one
dtype combination) and update the tensors **in place**, as the
reference's ops do; each returns nothing but the norms. CPU tensors take
the kernels' plain versions. The norms and LAMB's trust ratio have no
TPU kernel and stay PyTorch (``torch._foreach_norm``).

The ops read what amp keeps on the device, so an overflow-skipped step
needs no host synchronisation: the noop flag and ``found_inf``
(one-element fp32 tensors; a step is skipped where one is > 0, JAX's
``noop > 0``), the step count (a Python int, whose bias corrections are
taken on the host, or a one-element int32 tensor, read on the device)
and the (inverse) loss scale (a Python number or a one-element fp32
tensor). Pass these as tensors on
the parameters' device: a CPU tensor is copied there, which waits for
the device.
"""

import torch

from apex_tpu_torch.kernels import optim as _kernels
from apex_tpu_torch.kernels import scale as _scale


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


def device_scalar(value, device, dtype=torch.float32):
    """``value`` (a Python number or a tensor of one element) as a
    one-element ``dtype`` tensor on ``device``: a number is filled there
    (no copy); a tensor already there is viewed, not copied."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype).reshape(1)
    return torch.full((1,), value, dtype=dtype, device=device)


def _multiplier(value, device):
    """A gradient multiplier for the kernels: None where it is None or
    the number 1 (a product by 1 is exact), else a device scalar."""
    if value is None or (not isinstance(value, torch.Tensor) and value == 1.0):
        return None
    return device_scalar(value, device)


def multi_tensor_scale(noop_flag, tensor_lists, scale):
    """``out = x * scale`` over ``tensor_lists = [xs, outs]`` of fp32 or
    bf16 tensors, each product in fp32 and written into out in its own
    dtype (outs may be xs: amp unscales gradients in place); ``noop_flag``
    (a one-element fp32 tensor) is set to 1 where some fp32 product is
    inf or NaN, and never cleared. ``scale``: a number or a one-element
    tensor (amp passes 1 / loss scale, on the device)."""
    xs, outs = tensor_lists
    _scale.scale(noop_flag, xs, outs,
                 device_scalar(scale, noop_flag.device))


def multi_tensor_axpby(noop_flag, tensor_lists, a, b, arg_to_check=-1):
    """``out = a * x + b * y`` over ``tensor_lists = [xs, ys, outs]`` of
    fp32 or bf16 tensors (two fp32 products, then the sum, written in
    out's dtype), flagged as :func:`multi_tensor_scale` flags it: the
    result is checked whatever ``arg_to_check`` says, as in JAX."""
    xs, ys, outs = tensor_lists
    _scale.axpby(noop_flag, xs, ys, outs, a, b)


def multi_tensor_sgd(noop_flag, tensor_lists, wd, momentum, dampening, lr,
                     nesterov, first_run, wd_after_momentum, scale=1.0):
    """Fused SGD with momentum over ``tensor_lists = [grads, params,
    momentum_buffers]`` (fp32 params and buffers, fp32 or bf16 grads),
    updating params and buffers in place: each gradient times ``scale``
    (the multiplier, as JAX's: amp passes 1 / loss scale), L2 decay
    before or after the momentum, ``first_run`` (a bool, or a tensor of
    one element, true where non-zero) taking the gradient as the buffer.
    Nothing changes where ``noop_flag`` is > 0."""
    grads, params, moms = tensor_lists
    device = noop_flag.device
    if isinstance(first_run, torch.Tensor):
        step = first_run.reshape(1).to(device).eq(0).to(torch.int32)
    else:
        step = torch.full((1,), 0 if first_run else 1, dtype=torch.int32,
                          device=device)
    _kernels.sgd(noop_flag, grads, params, moms, step=step,
                 inv_scale=_multiplier(scale, device), wd=wd,
                 momentum=momentum, dampening=dampening, lr=lr,
                 nesterov=nesterov, wd_after_momentum=wd_after_momentum)


def _step_args(beta1, beta2, step, bias_correction, device):
    """The kernels' bias-correction arguments: none (1) without bias
    correction; for a tensor ``step``, that count on ``device`` (the
    kernels compute the corrections from it there); for an int, the
    host's :func:`bias_corrections`."""
    if not bias_correction:
        return dict(bc1=1.0, bc2=1.0, step=None)
    if isinstance(step, torch.Tensor):
        return dict(step=device_scalar(step, device, torch.int32))
    bc1, bc2 = bias_corrections(beta1, beta2, step)
    return dict(bc1=bc1, bc2=bc2, step=None)


def _adam(noop_flag, grads, params, ms, vs, outs, lr, beta1, beta2, eps, step,
          mode, bias_correction, weight_decay, inv_scale):
    if mode not in (0, 1):
        raise ValueError(f"multi_tensor_adam: mode must be 0 or 1, got {mode}")
    device = noop_flag.device
    # L2 decay of 0 adds nothing: the JAX op skips it, the kernel adds 0*p
    _kernels.adam(noop_flag, grads, params, ms, vs, outs, lr=lr, b1=beta1,
                  b2=beta2, eps=eps, weight_decay=weight_decay,
                  adam_w=(mode == 1), inv_scale=_multiplier(inv_scale, device),
                  **_step_args(beta1, beta2, step, bias_correction, device))


def multi_tensor_adam(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                      mode, bias_correction, weight_decay):
    """Fused Adam (``mode`` 0: L2 regularisation) or AdamW (``mode`` 1:
    decoupled weight decay) over ``tensor_lists = [grads, params,
    exp_avgs, exp_avg_sqs]``, updating params, exp_avgs and exp_avg_sqs
    in place. Nothing changes where ``noop_flag`` (a one-element fp32
    tensor on the tensors' device) is > 0. ``step`` is the step count
    after this update (1 on the first): an int (the bias corrections
    taken on the host) or an int32 tensor (read on the device)."""
    grads, params, exp_avgs, exp_avg_sqs = tensor_lists
    _adam(noop_flag, grads, params, exp_avgs, exp_avg_sqs, None, lr, beta1,
          beta2, eps, step, mode, bias_correction, weight_decay, None)


def multi_tensor_adam_capturable(noop_flag, tensor_lists, lr, beta1, beta2,
                                 eps, step, mode, bias_correction,
                                 weight_decay, inv_scale=1.0):
    """:func:`multi_tensor_adam` on what amp keeps on the device: the
    gradients (fp32 or bf16) times ``inv_scale`` inside the update, the
    step count (the count after this update; an int32 tensor is read on
    the device with its bias corrections). The params are fp32, or bf16
    (each update computed in fp32 and rounded back)."""
    grads, params, ms, vs = tensor_lists
    _adam(noop_flag, grads, params, ms, vs, None, lr, beta1, beta2, eps, step,
          mode, bias_correction, weight_decay, inv_scale)


def multi_tensor_adam_capturable_master(noop_flag, tensor_lists, lr, beta1,
                                        beta2, eps, step, mode,
                                        bias_correction, weight_decay,
                                        inv_scale=1.0):
    """:func:`multi_tensor_adam_capturable` on fp32 master weights:
    ``tensor_lists = [grads, params, exp_avgs, exp_avg_sqs, masters]``;
    masters, exp_avgs and exp_avg_sqs are updated in place and each
    (low-precision) param written from its new master in the same pass."""
    grads, params, ms, vs, masters = tensor_lists
    _adam(noop_flag, grads, masters, ms, vs, params, lr, beta1, beta2, eps,
          step, mode, bias_correction, weight_decay, inv_scale)


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


def multi_tensor_l2norm_mp(noop_flag, tensor_lists, per_tensor=False):
    """:func:`multi_tensor_l2norm`: the tensors are widened to fp32 before
    the sums either way."""
    return multi_tensor_l2norm(noop_flag, tensor_lists, per_tensor)


def multi_tensor_l2norm_scale(noop_flag, tensor_lists, scale,
                              per_tensor=False):
    """:func:`multi_tensor_l2norm` of each ``x * scale`` (fp32), the norm
    of gradients before they are unscaled."""
    (xs,) = tensor_lists
    if isinstance(scale, torch.Tensor) or scale != 1.0:
        xs = [x.float() * scale for x in xs]
    return multi_tensor_l2norm(noop_flag, [xs], per_tensor)


def _lamb_clip(global_grad_norm, max_grad_norm, device):
    """The global gradient-clip factor ``max(norm / max_grad_norm, 1)`` as
    a one-element fp32 tensor on ``device``, or None (no clipping)."""
    if max_grad_norm is None or max_grad_norm <= 0:
        return None
    gnorm = torch.as_tensor(global_grad_norm, dtype=torch.float32,
                            device=device)
    return torch.clamp(gnorm / max_grad_norm, min=1.0).reshape(1)


def _trust_factors(lr, params, updates, apply_trust):
    """``lr * ratio`` per tensor as an fp32 tensor [len(params)]: the trust
    ratio ||p|| / ||update|| where both are > 0, else 1, and 1 throughout
    unless ``apply_trust``."""
    if not apply_trust:
        return torch.full((len(params),), lr, dtype=torch.float32,
                          device=params[0].device)
    w_norm = torch.stack(torch._foreach_norm(params))
    u_norm = torch.stack(torch._foreach_norm(updates))
    return lr * torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm, 1.0)


def _lamb(noop_flag, found_inf, grads, params, exp_avgs, exp_avg_sqs, updates,
          outs, lr, beta1, beta2, eps, step, bias_correction, weight_decay,
          grad_averaging, mode, global_grad_norm, max_grad_norm, use_nvlamb,
          inv_scale):
    """Stage 1 into ``updates`` (None: over the grads), the trust factors,
    then stage 2 on ``params`` (writing ``outs`` from them, where given)."""
    if mode not in (0, 1):
        raise ValueError(f"multi_tensor_lamb: mode must be 0 or 1, got {mode}")
    if not params:
        return
    device = noop_flag.device
    _kernels.lamb(
        noop_flag, grads, params, exp_avgs, exp_avg_sqs, updates,
        found_inf=found_inf,
        clip=_lamb_clip(global_grad_norm, max_grad_norm, device),
        inv_scale=_multiplier(inv_scale, device), b1=beta1, b2=beta2,
        beta3=(1 - beta1) if grad_averaging else 1.0, eps=eps,
        weight_decay=weight_decay, adam_w=(mode == 1),
        **_step_args(beta1, beta2, step, bias_correction, device))
    updates = grads if updates is None else updates
    factors = _trust_factors(lr, params, updates,
                             weight_decay != 0 or use_nvlamb)
    _kernels.lamb_stage2(noop_flag, found_inf, params, updates, outs, factors)


def multi_tensor_lamb(noop_flag, tensor_lists, lr, beta1, beta2, eps, step,
                      bias_correction, weight_decay, grad_averaging, mode,
                      global_grad_norm, max_grad_norm, use_nvlamb=False, *,
                      outs=None):
    """Fused LAMB over ``tensor_lists = [grads, params, exp_avgs,
    exp_avg_sqs]`` of fp32 tensors, updating params, exp_avgs and
    exp_avg_sqs in place; each grad is left holding its tensor's raw
    update (the reference's stage 1 stores it there). Nothing changes
    in params, exp_avgs, exp_avg_sqs or grads where ``noop_flag`` (a
    one-element fp32 tensor on the tensors' device) is > 0.

    The gradients are divided by ``max(global_grad_norm / max_grad_norm,
    1)`` (when ``max_grad_norm`` > 0); ``mode`` 0 adds L2 decay to them,
    ``mode`` 1 adds decoupled decay to the update; the stage-1 kernel
    writes the moments and the update. Then, as in JAX, each parameter
    moves by ``lr * ratio * update`` (the stage-2 kernel), where the trust
    ratio is ||p|| / ||update|| when both are > 0 (else 1) and applies
    when ``weight_decay`` != 0 or ``use_nvlamb``. ``step`` is the step
    count after this update: an int (the bias corrections taken on the
    host) or an int32 tensor (read on the device). ``outs`` (the port's
    optimizers: params are fp32 masters): a list whose entries are a
    parameter to write from its new master, or None."""
    grads, params, exp_avgs, exp_avg_sqs = tensor_lists
    _lamb(noop_flag, None, grads, params, exp_avgs, exp_avg_sqs, None, outs,
          lr, beta1, beta2, eps, step, bias_correction, weight_decay,
          grad_averaging, mode, global_grad_norm, max_grad_norm, use_nvlamb,
          None)


def multi_tensor_lamb_mp(noop_flag, tensor_lists, lr, beta1, beta2, eps,
                         step, bias_correction, weight_decay, grad_averaging,
                         mode, global_grad_norm, max_grad_norm, use_nvlamb,
                         found_inf, inv_scale):
    """Mixed-precision LAMB over ``tensor_lists = [grads, params,
    exp_avgs, exp_avg_sqs, masters]``: the update is computed on the fp32
    masters from the gradients (fp32 or bf16) times ``inv_scale``, as
    :func:`multi_tensor_lamb` computes it; masters and moments are
    updated in place and each param (bf16 or fp32; none where it is its
    own master) written from its new master in the same pass. Nothing
    changes where ``noop_flag`` or ``found_inf`` (None: 0) is > 0 (JAX's
    ``max(noop_flag, found_inf)``). The grads are left as they were: the
    raw updates go to an fp32 buffer of the masters' size, freed after
    the call."""
    grads, params, exp_avgs, exp_avg_sqs, masters = tensor_lists
    if not masters:
        return
    device = noop_flag.device
    found = None if found_inf is None else device_scalar(found_inf, device)
    flat = torch.empty(sum(m.numel() for m in masters), dtype=torch.float32,
                       device=device)
    updates, at = [], 0
    for m in masters:
        updates.append(flat[at:at + m.numel()].view(m.shape))
        at += m.numel()
    outs = [None if p is mw else p for p, mw in zip(params, masters)]
    _lamb(noop_flag, found, grads, masters, exp_avgs, exp_avg_sqs, updates,
          outs, lr, beta1, beta2, eps, step, bias_correction, weight_decay,
          grad_averaging, mode, global_grad_norm, max_grad_norm, use_nvlamb,
          inv_scale)


def multi_tensor_adagrad(noop_flag, tensor_lists, lr, eps, mode,
                         weight_decay):
    """Fused Adagrad over ``tensor_lists = [grads, params, sums]`` (fp32
    params and sums, fp32 or bf16 grads), updating params and sums in
    place (``mode`` 0: L2 decay added to the gradient, 1: decoupled, to
    the update). Nothing changes where ``noop_flag`` is > 0."""
    grads, params, hs = tensor_lists
    _kernels.adagrad(noop_flag, grads, params, hs, lr=lr, eps=eps,
                     weight_decay=weight_decay, mode=mode)


def multi_tensor_novograd(noop_flag, tensor_lists, lr, beta1, beta2, eps,
                          step, bias_correction, weight_decay,
                          grad_averaging, moment_mode, norm_type,
                          init_zero=False):
    """Fused NovoGrad over ``tensor_lists = [grads, params, exp_avgs,
    v]``: fp32 params and exp_avgs, fp32 or bf16 grads, and ``v`` the
    per-tensor second moments, one fp32 vector [len(params)] (JAX's
    stacked ``exp_avg_sq``). Each tensor's v takes the squared norm of its
    gradient (``norm_type`` 2: L2, else the max norm), its first value
    (``init_zero``: ``(1 - beta2) * norm``, else the norm) where ``step``
    is 1; then params and exp_avgs move as JAX's op moves them
    (``moment_mode`` 0: L2 decay into the normalised gradient, 1:
    decoupled; ``grad_averaging``: beta3 = 1 - beta1). Params, exp_avgs
    and v are updated in place; nothing changes where ``noop_flag`` is
    > 0. ``step`` is the count after this update: an int or an int32
    tensor, read on the device (bc1 = 1 - beta1**step as JAX's traced
    power gives it)."""
    grads, params, exp_avgs, v = tensor_lists
    device = noop_flag.device
    _kernels.novograd(
        noop_flag, grads, params, exp_avgs, v,
        step=device_scalar(step, device, torch.int32), lr=lr, b1=beta1,
        b2=beta2, beta3=(1 - beta1) if grad_averaging else 1.0, eps=eps,
        weight_decay=weight_decay, moment_mode=moment_mode,
        norm_type=norm_type, init_zero=init_zero,
        bias_correction=bias_correction)


def _fp32_params(name, params):
    """Refuse parameters other than fp32: the LAMB kernels move fp32
    parameters (or masters) only."""
    for k, p in enumerate(params):
        if p.dtype != torch.float32:
            raise TypeError(f"{name}: parameter {k} is {p.dtype}; the two "
                            f"LAMB stages take float32 parameters (keep "
                            f"fp32 masters of low-precision ones)")


def multi_tensor_lamb_stage1(noop_flag, tensor_lists, per_tensor_decay,
                             step, beta1, beta2, beta3, bias_correction,
                             eps, grad_averaging, mode, global_grad_norm,
                             max_global_grad_norm):
    """LAMB's first public stage over ``tensor_lists = [grads, params,
    exp_avgs, exp_avg_sqs, updates]``: each grad (fp32 or bf16) divided
    by the clip factor ``max(global_grad_norm / max_global_grad_norm,
    1)`` (when that maximum is > 0), exp_avgs and exp_avg_sqs updated in
    place and each tensor's raw update ``m_hat / (sqrt(v_hat) + eps)``
    (plus its decay, ``mode`` 0: L2 into the gradient, 1: decoupled)
    written into ``updates`` (fp32). ``per_tensor_decay`` gives each
    tensor's decay (the tensors of each distinct value take launches of
    their own); ``beta3`` the gradient's weight in m (None: ``1 - beta1``
    with ``grad_averaging``, else 1). ``step`` is the count after this
    update, an int or an int32 tensor. Params are fp32 (bf16 ones are
    refused). Nothing is written where ``noop_flag`` is > 0, the updates
    included (JAX's op returns them computed, and its stage 2 discards
    them under the same flag)."""
    grads, params, exp_avgs, exp_avg_sqs, updates = tensor_lists
    if mode not in (0, 1):
        raise ValueError(f"multi_tensor_lamb_stage1: mode must be 0 or 1, "
                         f"got {mode}")
    _fp32_params("multi_tensor_lamb_stage1", params)
    if not params:
        return
    if beta3 is None:
        beta3 = (1.0 - beta1) if grad_averaging else 1.0
    device = noop_flag.device
    _kernels.lamb(
        noop_flag, grads, params, exp_avgs, exp_avg_sqs, updates,
        clip=_lamb_clip(global_grad_norm, max_global_grad_norm, device),
        b1=beta1, b2=beta2, beta3=beta3, eps=eps,
        weight_decay=list(per_tensor_decay), adam_w=(mode == 1),
        **_step_args(beta1, beta2, step, bias_correction, device))


def multi_tensor_lamb_stage2(noop_flag, tensor_lists, per_tensor_decay, lr,
                             use_nvlamb=False):
    """LAMB's second public stage over ``tensor_lists = [params,
    updates]`` (fp32): each param moves by ``lr * ratio * update``, with
    the trust ratio ||p|| / ||update|| (1 where either is 0) where
    ``use_nvlamb`` or that tensor's decay is not 0, else 1 (JAX's gate,
    tensor by tensor). Params are updated in place; nothing changes where
    ``noop_flag`` is > 0."""
    params, updates = tensor_lists
    _fp32_params("multi_tensor_lamb_stage2", params)
    if not params:
        return
    applied = torch.tensor([bool(use_nvlamb or wd != 0)
                            for wd in per_tensor_decay])
    if len(applied) != len(params):
        raise ValueError(f"multi_tensor_lamb_stage2: {len(applied)} decays "
                         f"for {len(params)} tensors")
    factors = _trust_factors(lr, params, updates, bool(applied.any()))
    if not applied.all():
        factors = torch.where(applied.to(factors.device), factors,
                              torch.full_like(factors, lr))
    _kernels.lamb_stage2(noop_flag, None, params, updates, None, factors)
