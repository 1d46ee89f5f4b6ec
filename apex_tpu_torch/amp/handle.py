"""``amp.scale_loss`` and ``disable_casts``.

Counterpart of ``apex_tpu/amp/handle.py`` (reference apex/amp/
handle.py:16-158 and 163-167). The reference unscales the gradients and
patches the optimizer's step when the context exits; as in JAX, here
the context only yields the scaled loss, and the wrapped optimizer's
``step()`` unscales, checks for overflow and skips on the device:

    with amp.scale_loss(loss, optimizer) as scaled:
        scaled.backward()
    optimizer.step()
"""

import contextlib

from apex_tpu_torch.amp._amp_state import _amp_state


@contextlib.contextmanager
def scale_loss(loss, optimizers, loss_id=0, model=None,
               delay_unscale=False, delay_overflow_check=False):
    """Yield ``loss.float() * scale``, the scale of loss scaler
    ``loss_id`` read on the device (no host synchronisation); ``loss``
    itself while amp is not enabled."""
    props = _amp_state.opt_properties
    if props is None or not props.enabled:
        yield loss
        return
    if loss_id >= len(_amp_state.loss_scalers):
        raise RuntimeError(f"Invalid loss_id {loss_id}")
    yield _amp_state.loss_scalers[loss_id].scale(loss)


@contextlib.contextmanager
def disable_casts():
    """Turn the O1 dtype policy off in this thread inside the block."""
    from apex_tpu_torch.amp import policy

    prev = getattr(policy._local, "policy", None)
    policy._local.policy = policy.DtypePolicy(enabled=False)
    try:
        yield
    finally:
        policy._local.policy = prev
