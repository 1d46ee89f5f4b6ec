"""Loss scaler with a static and a dynamic mode.

Counterpart of ``apex_tpu/amp/scaler.py`` (reference apex/amp/
scaler.py:33-217): the dynamic scale starts at min(max_loss_scale,
2^16), halves on an overflow (floor ``min_loss_scale``, 1 when None; 0 is
a legal floor: no floor at all), and doubles after ``scale_window`` clean
steps in a row, up to ``max_loss_scale``. The state is two tensors on
the device, a fp32 scale and an int32 count of clean steps since the
last change (:class:`ScalerState`), and :meth:`LossScaler.update` is
device arithmetic on them: JAX keeps the same pair inside its jitted
step, and neither reads the overflow flag on the host (the reference
synchronises on it, scaler.py:200). The eager methods that return host
numbers (``loss_scale``, ``update_scale``, ``state_dict``) wait for the
device.
"""

from typing import NamedTuple

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.multi_tensor import multi_tensor_scale


class ScalerState(NamedTuple):
    loss_scale: torch.Tensor  # fp32 [] on the device
    unskipped: torch.Tensor   # int32 []: clean steps since the last change


class LossScaler:
    def __init__(self, loss_scale, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_loss_scale=None,
                 max_loss_scale=2.0 ** 24, device=None):
        if loss_scale == "dynamic":
            self.dynamic = True
            self._loss_scale = min(max_loss_scale, init_scale)
        else:
            self.dynamic = False
            self._loss_scale = loss_scale
        self._max_loss_scale = max_loss_scale
        self._min_loss_scale = min_loss_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self.device = resolve_device(device)
        self._state = self.init_state()
        self._last_found_inf = None

    # -- functional API (no host synchronisation) --------------------------
    def init_state(self) -> ScalerState:
        return ScalerState(
            loss_scale=torch.full((), self._loss_scale, dtype=torch.float32,
                                  device=self.device),
            unskipped=torch.zeros((), dtype=torch.int32, device=self.device))

    def scale(self, loss, state: ScalerState = None):
        """``loss`` in fp32 times the current scale (a device product)."""
        return loss.float() * (state or self._state).loss_scale

    def unscale_grads(self, grads, state: ScalerState = None):
        """Unscale the gradient tensors ``grads`` in place (each times
        1 / scale in fp32, written back in its own dtype); returns
        ``(grads, found_inf)``, found_inf a one-element fp32 device tensor
        that is 1 where some product is not finite."""
        state = state or self._state
        found_inf = torch.zeros(1, dtype=torch.float32, device=self.device)
        grads = list(grads)
        if grads:
            multi_tensor_scale(found_inf, [grads, grads],
                               torch.reciprocal(state.loss_scale))
        return grads, found_inf

    def update(self, state: ScalerState, found_inf) -> ScalerState:
        """The next state after a step whose overflow flag is
        ``found_inf`` (JAX's ``update``, as device arithmetic; the state
        passed in is left as it is). A static scaler returns ``state``.
        Telemetry: :meth:`record_update` (nothing read from the card
        unless the registry is enabled)."""
        if not self.dynamic:
            return state
        overflow = found_inf.reshape(()) > 0
        floor = 1.0 if self._min_loss_scale is None else self._min_loss_scale
        grow = state.unskipped + 1 >= self._scale_window
        new_scale = torch.where(
            overflow,
            torch.clamp(state.loss_scale / self._scale_factor, min=floor),
            torch.where(grow,
                        torch.clamp(state.loss_scale * self._scale_factor,
                                    max=self._max_loss_scale),
                        state.loss_scale))
        new_unskipped = torch.where(overflow | grow, 0,
                                    state.unskipped + 1).to(torch.int32)
        new_state = ScalerState(new_scale, new_unskipped)
        self.record_update(state, new_state, found_inf)
        return new_state

    def record_update(self, state, new_state, found_inf, registry=None):
        """Host-side telemetry of one update (JAX's ``amp/loss_scale``
        gauge, ``amp/overflow`` and ``amp/scale_window_growth`` counters
        and ``amp`` event). With the registry disabled (the default) it
        reads nothing from the card; enabled, it costs one host read of
        three scalars (the old and new scale and the flag, one copy) a
        call — :meth:`update` calls it every step."""
        from apex_tpu_torch.telemetry.registry import get_registry

        reg = registry or get_registry()
        if not reg.enabled:
            return
        prev, scale, flag, unskipped = torch.stack([
            torch.as_tensor(state.loss_scale, dtype=torch.float32).reshape(()),
            torch.as_tensor(new_state.loss_scale,
                            dtype=torch.float32).reshape(()),
            torch.as_tensor(found_inf, dtype=torch.float32).reshape(-1)[0]
            .to(torch.as_tensor(state.loss_scale).device),
            torch.as_tensor(new_state.unskipped).to(torch.float32).reshape(()),
        ]).cpu().tolist()
        overflow = flag > 0
        grew = scale > prev
        reg.gauge("amp/loss_scale").set(scale)
        if overflow:
            reg.counter("amp/overflow").inc()
        if grew:
            reg.counter("amp/scale_window_growth").inc()
        reg.event("amp", "loss_scale", scale=scale, overflow=overflow,
                  grew=grew, unskipped=int(unskipped))

    # -- eager API (reference parity; these wait for the device) -----------
    def loss_scale(self):
        return float(self._state.loss_scale)

    def unscale(self, grads):
        grads, self._last_found_inf = self.unscale_grads(grads, self._state)
        return grads

    def update_scale(self):
        """Update the scaler's own state from the last :meth:`unscale`;
        returns whether that step overflowed."""
        found_inf = self._last_found_inf
        if found_inf is None:
            found_inf = torch.zeros(1, dtype=torch.float32,
                                    device=self.device)
        self._state = self.update(self._state, found_inf)
        self._last_found_inf = None
        return bool(found_inf.reshape(()) > 0)

    # -- checkpointing (reference frontend.py:365-404) ---------------------
    def state_dict(self):
        return {"loss_scale": float(self._state.loss_scale),
                "unskipped": int(self._state.unskipped),
                "dynamic": self.dynamic}

    def load_state_dict(self, sd):
        self.dynamic = sd.get("dynamic", self.dynamic)
        self._state = ScalerState(
            loss_scale=torch.full((), sd["loss_scale"], dtype=torch.float32,
                                  device=self.device),
            unskipped=torch.full((), sd.get("unskipped", 0),
                                 dtype=torch.int32, device=self.device))
