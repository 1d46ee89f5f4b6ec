"""LARC: layer-wise adaptive rate clipping or scaling around an optimizer.

Counterpart of ``apex_tpu/parallel/LARC.py`` (reference
apex/parallel/LARC.py:5-107), in PyTorch's idiom: it wraps a port
optimizer (``FusedAdam``, ``FusedLAMB``) and its ``step()`` rescales each
``p.grad`` in place before stepping the inner optimizer. Per parameter,
``adaptive_lr = trust_coefficient * ||p|| / (||g|| + weight_decay * ||p||
+ eps)`` (the group's lr where either norm is 0); in ``clip`` mode the
gradient is scaled by ``min(adaptive_lr / lr, 1)``, else by
``adaptive_lr / lr``, after ``weight_decay * p`` is added to it.

    opt = LARC(FusedAdam(model.parameters(), lr=1e-3))
    loss.backward(); opt.step(); opt.zero_grad()

amp's ``found_inf`` and ``scale`` pass through to the wrapped
optimizer's ``step``, as JAX's LARC passes them.
"""

import torch


class LARC:
    def __init__(self, optimizer, trust_coefficient=0.02, clip=True, eps=1e-8,
                 weight_decay=0.0):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def lr(self):
        return self.optim.param_groups[0]["lr"]

    def zero_grad(self, set_to_none: bool = True):
        self.optim.zero_grad(set_to_none=set_to_none)

    def _rescale(self, g, p, lr):
        """``g`` rescaled for parameter ``p`` at learning rate ``lr``, in
        g's dtype (JAX's ``_rescale`` for one leaf)."""
        g32, p32 = g.float(), p.float()
        lr = torch.full((), lr, dtype=torch.float32, device=g.device)
        p_norm = torch.sqrt(torch.sum(torch.square(p32)))
        g_norm = torch.sqrt(torch.sum(torch.square(g32)))
        adaptive_lr = self.trust_coefficient * p_norm / (
            g_norm + self.weight_decay * p_norm + self.eps)
        # zero-norm parameters fall back to the plain lr (reference :95)
        adaptive_lr = torch.where((p_norm > 0) & (g_norm > 0), adaptive_lr,
                                  lr)
        ratio = adaptive_lr / lr
        if self.clip:
            ratio = torch.clamp_max(ratio, 1.0)
        g32 = g32 + self.weight_decay * p32
        return (g32 * ratio).to(g.dtype)

    @torch.no_grad()
    def step(self, closure=None, *, found_inf=None, scale=1.0):
        """Rescale every ``p.grad``, then step the wrapped optimizer
        with ``found_inf`` and ``scale``."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.optim.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.copy_(self._rescale(p.grad, p, group["lr"]))
        self.optim.step(found_inf=found_inf, scale=scale)
        return loss
