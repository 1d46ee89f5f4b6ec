"""apex_tpu_torch.resilience.supervisor against apex_tpu's on the CPU:
the StepLedger, and the Supervisor over the JAX package's failure matrix
(its tests/L0/test_supervisor.py stub scenarios: a clean run, numerics
escalation with snapshot restore and loss-scale backoff, a bounded
restart budget, an unknown failure re-raised, capped exponential
backoff, a torn periodic checkpoint restored from the last good step,
preemption with a final save and a resume in a new supervisor, device
loss with a mesh shrink). Each scenario runs in both packages and the
reports (exit, steps, restarts, causes, restores, steps lost, MTTR,
goodput, ledger), the waits, the final state and the recorded counters
must be equal. Then the mesh shrink 2 -> 1 through a ``rebuild`` hook
over the port's elastic ZeRO state: the masters and moments restore bit
for bit on the smaller world.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.checkpoint as jckpt
import apex_tpu.resilience as jres
from apex_tpu import telemetry as jtel
from apex_tpu_torch import checkpoint as tckpt
from apex_tpu_torch import resilience as tres
from apex_tpu_torch import telemetry as ttel
from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.resilience.supervisor import HotSnapshots
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": dict(res=jres, ckpt=jckpt, tel=jtel,
                state=lambda: {"x": jnp.zeros(()),
                               "loss_scale": np.float32(8.0)},
                add=lambda x: x + 1),
    "torch": dict(res=tres, ckpt=tckpt, tel=ttel,
                  state=lambda: {"x": torch.zeros(()),
                                 "loss_scale": torch.tensor(8.0)},
                  add=lambda x: x + 1),
}


def _step(pkg):
    return lambda state, i: {"x": pkg["add"](state["x"]),
                             "loss_scale": state["loss_scale"]}


def _torn_second_write(pkg, path, host_state, real, state, *rest):
    """The second write lands truncated behind a full manifest."""
    state["writes"] += 1
    if state["writes"] != 2:
        return real(path, host_state, *rest)
    import json

    ck = pkg["ckpt"]
    tree, bf16 = (host_state, None) if rest else host_state
    payload = pickle.dumps(tree)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.pkl"), "wb") as f:
        f.write(payload[:24])
    manifest = ck._manifest_for(tree, "pickle") if rest else \
        ck._manifest_for(tree, bf16)
    manifest["files"] = {"state.pkl": {
        "size": len(payload), "sha256": ck._sha256_bytes(payload)}}
    with open(os.path.join(path, ck.MANIFEST_NAME), "w") as f:
        json.dump(manifest, f)


def _scenario(name, pkg, tmp):
    res = pkg["res"]
    waits = []
    mk = dict(sleep=waits.append, snapshot_every=2)
    step = _step(pkg)
    extra = {}
    if name == "clean":
        sup = res.Supervisor(step, pkg["state"](), **mk)
        rep = sup.run(5)
    elif name == "numerics":
        fired = []

        def bad(state, i):
            if i == 3 and not fired:
                fired.append(i)
                raise res.NonFiniteError("escalated")
            return step(state, i)

        sup = res.Supervisor(bad, pkg["state"](), **mk)
        rep = sup.run(6)
    elif name == "bounded":
        def always(state, i):
            raise res.NonFiniteError("never recovers")

        sup = res.Supervisor(always, pkg["state"](), **dict(
            mk, snapshot_every=1))
        with pytest.raises(res.RecoveryExhaustedError, match="budget"):
            sup.run(3)
        rep = None
    elif name == "unknown":
        def unk(state, i):
            raise ValueError("not a known class")

        sup = res.Supervisor(unk, pkg["state"](), **mk)
        with pytest.raises(ValueError, match="not a known class"):
            sup.run(2)
        rep = None
    elif name == "backoff":
        fired = []

        def flaky(state, i):
            if len(fired) < 3:
                fired.append(i)
                raise res.NonFiniteError("x")
            return step(state, i)

        sup = res.Supervisor(flaky, pkg["state"](), **dict(
            mk, snapshot_every=1, policies={
                res.FailureClass.NUMERICS: res.RecoveryPolicy(
                    "snapshot_restore", max_restarts=5, backoff_base_s=0.1,
                    backoff_cap_s=0.25)}))
        rep = sup.run(2)
    elif name == "torn_checkpoint":
        ck = pkg["ckpt"]
        real = ck._write_state
        count = {"writes": 0}
        ck._write_state = lambda path, host, *rest: _torn_second_write(
            pkg, path, host, real, count, *rest)
        try:
            sup = res.Supervisor(step, pkg["state"](), **dict(
                mk, checkpoint_dir=str(tmp), checkpoint_every=2,
                snapshot_every=100))
            with pytest.warns(UserWarning, match="REJECTED step 2"):
                rep = sup.run(5)
        finally:
            ck._write_state = real
        extra = {"settled": sup.last_restore_meta["settled_step"],
                 "rejected": [r["step"] for r in
                              sup.last_restore_meta["rejected"]]}
    elif name == "preemption":
        guard = res.PreemptionGuard(signals=())
        hit = []

        def pre(state, i):
            if i == 2 and not hit:
                hit.append(i)
                guard.trigger()
            return step(state, i)

        with guard:
            sup = res.Supervisor(pre, pkg["state"](), **dict(
                mk, checkpoint_dir=str(tmp), preemption_guard=guard,
                snapshot_every=100))
            rep = sup.run(10)
        sup2 = res.Supervisor(step, pkg["state"](), **dict(
            mk, checkpoint_dir=str(tmp)))
        meta = sup2.restore_from_checkpoint()
        rep2 = sup2.run(10)
        extra = {"settled": meta["settled_step"], "resume": _report(rep2),
                 "x2": float(sup2.state["x"])}
    elif name == "device_loss":
        def make(world):
            def st(state, i):
                if world == 8 and i == 3:
                    raise res.DeviceLostError("DEVICE_LOST: injected",
                                              shrink_to=4)
                return step(state, i)
            return st

        rebuilds = []

        def rebuild(world, host_state, at):
            rebuilds.append((world, at))
            return make(world), host_state

        sup = res.Supervisor(make(8), pkg["state"](), **dict(
            mk, rebuild=rebuild, world=8, topology={"world": 8}))
        rep = sup.run(6)
        extra = {"rebuilds": rebuilds, "topology": sup.topology}
    out = {"report": _report(rep), "waits": waits, "extra": extra,
           "x": float(sup.state["x"]),
           "loss_scale": float(sup.state["loss_scale"])}
    return out


def _report(rep):
    if rep is None:
        return None
    keys = ("exit", "final_step", "world", "restarts", "causes",
            "snapshot_restores", "checkpoint_restores", "mesh_shrinks",
            "steps_lost", "mttr_steps", "dispatches", "goodput_step_ratio",
            "ledger")
    return {k: rep[k] for k in keys}


@pytest.mark.parametrize("name", [
    "clean", "numerics", "bounded", "unknown", "backoff", "torn_checkpoint",
    "preemption", "device_loss"])
def test_failure_matrix_matches_jax(name, tmp_path):
    got = {}
    for which in ("jax", "torch"):
        pkg = PKGS[which]
        reg = pkg["tel"].MetricsRegistry(enabled=True)
        with pkg["tel"].use_registry(reg):
            out = _scenario(name, pkg, tmp_path / which)
        # the supervisor's counters (JAX's also count its own XLA
        # compiles under compile/, which the port has no counterpart of
        # in these stub steps)
        out["counters"] = {k: v for k, v in reg.snapshot()["counters"].items()
                           if not k.startswith("compile/")}
        got[which] = out
    assert got["torch"] == got["jax"]


def test_ledger_matches_jax():
    for pkg in (jres, tres):
        led = pkg.StepLedger()
        for i in range(4):
            led.record_apply(i)
        assert led.record_rollback(2, cause="numerics") == 2
        for i in range(2, 6):
            led.record_apply(i)
        out = led.verify(expect_next=6)
        assert out["rollbacks"] == 1 and out["applies"] == 8
        with pytest.raises(pkg.LedgerError, match="double-applied"):
            led.record_apply(3)
        with pytest.raises(pkg.LedgerError, match="steps were lost"):
            led.verify(expect_next=9)


def test_hot_snapshots_copy_to_the_host_and_backoff():
    snaps = HotSnapshots(keep=2)
    for i in range(4):
        snaps.take(i, {"x": torch.tensor(float(i)), "n": i})
    assert len(snaps) == 2 and snaps.latest().step == 3
    copy = HotSnapshots.copy_state(snaps.latest())
    copy["x"] = None
    assert snaps.latest().state["x"] is not None
    adj = tres.loss_scale_backoff(factor=0.5, min_scale=2.0)
    assert float(adj({"loss_scale": torch.tensor(8.0)}, None)[
        "loss_scale"]) == 4.0
    assert float(adj({"loss_scale": torch.tensor(2.5)}, None)[
        "loss_scale"]) == 2.0


def _params():
    rng = np.random.RandomState(0)
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in {"w": (24, 20), "b": (20,), "e": (37, 13)}.items()}


def test_mesh_shrink_2_to_1_over_the_elastic_zero_state():
    """The device-loss policy's rebuild re-partitions the ZeRO state
    written at world 2 onto world 1 (``state_dict_full`` then
    ``load_state_dict_resharded``): the consolidated masters and moments
    are bit for bit the ones before the loss."""
    opt = DistributedFusedAdam()
    params = _params()
    full = {"master": torch.cat([p.reshape(-1) for p in params.values()
                                 ]).numpy() * 0.5}
    n = full["master"].size
    rng = np.random.RandomState(1)
    full.update(exp_avg=rng.randn(n).astype(np.float32),
                exp_avg_sq=rng.rand(n).astype(np.float32))
    from apex_tpu_torch.contrib.optimizers import distributed_fused_adam as dfa

    start = dfa.reshard_zero_state(dict(full, step=np.int32(2)), params,
                                   world=2)
    want = opt.state_dict_full(start, params, world=2)
    seen = []

    def make(world):
        def step(state, i):
            if world == 2 and i == 3:
                raise tres.DeviceLostError("DEVICE_LOST: rank 1",
                                           shrink_to=1)
            return dict(state, x=state["x"] + 1)
        return step

    def rebuild(world, host_state, at):
        full_now = opt.state_dict_full(host_state["zero"], params, world=2)
        seen.append((world, at))
        return make(world), dict(host_state, zero=opt.load_state_dict_resharded(
            full_now, params, world=world))

    sup = tres.Supervisor(make(2), {"x": torch.zeros(()), "zero": start},
                          rebuild=rebuild, world=2, snapshot_every=2,
                          sleep=lambda s: None)
    rep = sup.run(5)
    assert rep["mesh_shrinks"] == 1 and rep["world"] == 1
    assert seen == [(1, 2)] and float(sup.state["x"]) == 5
    got = opt.state_dict_full(sup.state["zero"], params, world=1)
    for k in ("master", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
