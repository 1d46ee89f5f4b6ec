"""The legacy loss scalers: a static :class:`LossScaler` and a
:class:`DynamicLossScaler`, on the host.

Counterpart of ``apex_tpu/fp16_utils/loss_scaler.py`` (reference
``apex/fp16_utils/loss_scaler.py``), with its host arithmetic: the scale
is a Python number. The dynamic scaler halves it on an overflow, floored
at 1, and doubles it when ``(cur_iter - last_overflow_iter) %
scale_window == 0``; ``cur_iter`` advances on every update, overflowed
or not. (amp's scaler, :mod:`apex_tpu_torch.amp.scaler`, keeps its
state on the device instead.)
"""

import torch


def _has_overflow(grads):
    """Whether some tensor of ``grads`` (None entries skipped) holds inf
    or NaN, read on the host (one synchronisation)."""
    flags = [~torch.isfinite(g.float()).all() for g in grads if g is not None]
    return bool(torch.stack(flags).any()) if flags else False


class LossScaler:
    """A static loss scale."""

    def __init__(self, scale=1.0):
        self.cur_scale = scale

    def has_overflow(self, params):
        return False

    def update_scale(self, overflow):
        pass

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, grads):
        """Each gradient times the scale (new tensors)."""
        return [g * self.loss_scale for g in grads]

    def backward(self, loss, retain_graph=False):
        """Backward of ``loss`` times the scale; returns that product
        (JAX's ``backward`` returns it for the caller to differentiate)."""
        scaled = loss * self.loss_scale
        scaled.backward(retain_graph=retain_graph)
        return scaled


class DynamicLossScaler(LossScaler):
    """A dynamic loss scale: backoff by ``scale_factor`` on an overflow
    (not below 1), growth by it every ``scale_window`` iterations after
    the last overflow."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0,
                 scale_window=1000):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window

    def has_overflow(self, grads):
        """Whether some gradient of ``grads`` holds inf or NaN (a host
        read)."""
        return _has_overflow(grads)

    def update_scale(self, overflow):
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1
