"""apex_tpu_torch.checkpoint against apex_tpu.checkpoint on the CPU.

- The manifest of the same state is JAX's (each leaf's path, shape,
  dtype and crc32; bf16 leaves stored as their uint16 bits but named
  ``"bfloat16"`` with the crc of the same bytes).
- Cross restores: a step this package wrote restores in JAX (fp32 and
  int32 leaves), a step JAX wrote restores here (fp32, int32 and bf16),
  every leaf bit for bit.
- Durability: a torn write is rejected and the resume path walks back to
  the last verified step; transient write failures retry; a corrupted
  byte is caught; ``keep_last_n`` prunes only behind a verified save;
  ``AsyncCheckpointer`` lands the same bytes as ``save``; the training
  bundle round-trips a module's, an optimizer's and a scaler's
  ``state_dict``.
"""

import os
import pickle
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import checkpoint as jckpt
from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import faults
from torch_threads import one_torch_thread  # noqa: F401


def _np_state(seed=0, bf16=True):
    rng = np.random.RandomState(seed)
    st = {"params": {"w": rng.randn(6, 5).astype(np.float32),
                     "b": rng.randn(5).astype(np.float32)},
          "opt": {"step": np.int32(3),
                  "mu": [rng.randn(4).astype(np.float32),
                         rng.randint(0, 9, (3, 2)).astype(np.int32)]},
          "lr": 0.5, "step": 7}
    if bf16:
        st["params"]["h"] = rng.randn(3, 4).astype(ml_dtypes.bfloat16)
    return st


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_torch(v) for v in x]
    if isinstance(x, np.ndarray) or isinstance(x, np.generic):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return x


def _leaves_np(x):
    if isinstance(x, dict):
        return {k: _leaves_np(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_leaves_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return x


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def _manifest(path):
    import json

    with open(os.path.join(path, ckpt.MANIFEST_NAME)) as f:
        return json.load(f)


def test_manifest_equals_jax(tmp_path):
    st = _np_state()
    pj = jckpt.save(str(tmp_path / "j"), 1, st, use_orbax=False)
    pt = ckpt.save(str(tmp_path / "t"), 1, _to_torch(st))
    mj, mt = _manifest(pj), _manifest(pt)
    assert mt["leaves"] == mj["leaves"]
    assert mt["num_leaves"] == mj["num_leaves"] and mt["writer"] == "pickle"
    assert any(e["dtype"] == "bfloat16" for e in mt["leaves"])
    assert ckpt.verify_checkpoint(pt)["files"]["state.pkl"]["size"] > 0


def test_cross_restore_both_ways(tmp_path):
    # this package -> JAX (fp32 and int32 leaves: no bf16 bits there)
    st = _np_state(1, bf16=False)
    ckpt.save(str(tmp_path / "t"), 2, _to_torch(st))
    back = jckpt.restore(str(tmp_path / "t"), use_orbax=False)
    _equal_trees(back, {**st, "opt": {"step": np.asarray(np.int32(3)),
                                      "mu": st["opt"]["mu"]}})
    # JAX -> this package, bf16 included
    st = _np_state(2)
    jckpt.save(str(tmp_path / "j"), 4, st, use_orbax=False)
    got = ckpt.restore(str(tmp_path / "j"))
    assert got["params"]["h"].dtype == torch.bfloat16
    _equal_trees(_leaves_np(got), {**st, "opt": {
        "step": np.asarray(np.int32(3)), "mu": st["opt"]["mu"]}})
    # and this package's own bf16 round trip
    ckpt.save(str(tmp_path / "t2"), 5, _to_torch(st))
    _equal_trees(_leaves_np(ckpt.restore(str(tmp_path / "t2"))),
                 _leaves_np(ckpt.restore(str(tmp_path / "j"))))
    # a payload of numpy arrays in plain containers: no class of either
    # package, no ml_dtypes (bf16 as uint16)
    with open(os.path.join(ckpt._step_dir(str(tmp_path / "t2"), 5),
                           "state.pkl"), "rb") as f:
        raw = pickle.load(f)
    assert raw["params"]["h"].dtype == np.uint16
    assert type(raw["opt"]) is dict and type(raw["opt"]["mu"]) is list


def test_torn_write_walks_back_and_retries(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.arange(10.0)})
    with faults.torn_checkpoint_write() as torn:
        ckpt.save(d, 2, {"x": torch.arange(10.0) + 1})
    assert torn["fired"] == 1 and ckpt.latest_step(d) == 2
    with pytest.warns(UserWarning, match="REJECTED step 2"):
        st, meta = ckpt.restore(d, with_metadata=True)
    assert meta["settled_step"] == 1 and [r["step"] for r in
                                          meta["rejected"]] == [2]
    assert torch.equal(st["x"], torch.arange(10.0))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(d, step=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with faults.failing_checkpoint_writes(2) as fail:
            ckpt.save(d, 3, {"x": torch.ones(3)}, retries=2,
                      retry_base_delay=0.0)
    assert fail["fired"] == 2
    assert torch.equal(ckpt.restore(d, step=3)["x"], torch.ones(3))
    faults.corrupt_checkpoint(d, 3)
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.restore(d, step=3)


def test_keep_last_n_and_async_checkpointer(tmp_path):
    d = str(tmp_path / "a")
    with ckpt.AsyncCheckpointer(keep_last_n=2) as ac:
        for step in range(4):
            ac.save(d, step, {"x": torch.full((4,), float(step))})
        ac.wait_until_finished()
        assert ac.last_bytes > 0 and ac.last_write_seconds >= 0
    assert ckpt._all_steps(d) == [2, 3]
    assert torch.equal(ckpt.restore(d)["x"], torch.full((4,), 3.0))
    ckpt.save(str(tmp_path / "b"), 3, {"x": torch.full((4,), 3.0)})
    assert _manifest(ckpt._step_dir(d, 3))["leaves"] == _manifest(
        ckpt._step_dir(str(tmp_path / "b"), 3))["leaves"]


def test_training_state_bundle_round_trips(tmp_path):
    model = torch.nn.Linear(4, 3)
    opt = FusedAdam(model.parameters(), lr=0.1)
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    scaler = LossScaler("dynamic", device="cpu")
    scaler._state = scaler.update(scaler._state, torch.ones(1))
    ckpt.save_training_state(str(tmp_path), 1, model.state_dict(),
                             opt.state_dict(), scaler=scaler,
                             topology={"world": 1})
    other = LossScaler("dynamic", device="cpu")
    st = ckpt.restore_training_state(str(tmp_path), scaler=other)
    assert other.state_dict() == scaler.state_dict()
    assert st["topology"] == {"world": 1} and st["step"] == 1
    fresh = torch.nn.Linear(4, 3)
    fresh.load_state_dict(st["params"])
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                 model.parameters()))
    opt2 = FusedAdam(fresh.parameters(), lr=0.1)
    opt2.load_state_dict(st["opt_state"])
    for p, q in zip(model.parameters(), fresh.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], opt2.state[q][k])
