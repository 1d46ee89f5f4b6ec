"""apex_tpu_torch.resilience (guard, faults, preemption) against
apex_tpu.resilience on the CPU.

- ``parse_fault_plan`` parses the same specs to the same entries and
  refuses the same bad ones; ``inject_nan`` poisons the same leaves of a
  tree; ``classify_failure`` routes the port's exceptions
  (``torch.cuda.OutOfMemoryError`` to the OOM class).
- ``guarded_update`` over a planted NaN sequence keeps the same
  ``GuardState`` as JAX's step for step, and ``check_guard`` escalates
  at the same step.
- The guarded amp O2 step of a two-layer GPT with ``FusedAdam`` (fp32
  masters, the plain versions of K1, #12 and K7 on the CPU): a poisoned
  step leaves the parameters, masters, moments and step count bit for
  bit as they were, the loss scale halves, the next step commits, and
  the flight recorder's post-mortem names the poisoned module prefix.
- ``PreemptionGuard``: a real SIGTERM sets the flag, the final save runs
  once, and the previous handlers come back.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.resilience import faults as jfaults
from apex_tpu.resilience import guard as jguard
from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    gpt_loss_fn,
    init_weights,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import (
    FailureClass,
    NonFiniteError,
    PreemptionGuard,
    check_guard,
    classify_failure,
    faults,
    guarded_update,
    init_guard_state,
)
from apex_tpu_torch.telemetry import FlightRecorder, numerics
from apex_tpu_torch.telemetry.memory import HBMExhaustedError
from torch_threads import one_torch_thread  # noqa: F401

GPT_KW = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
              vocab_size=256, max_position_embeddings=64,
              use_flash_attention=False)
BATCH, SEQ = 2, 16

SPECS = ["", "nan@3:layer1;alloc@5;preempt@9", "decode@2:persistent",
         "slot_nan@4:1; ckpt_torn@0 ;ckpt_fail@2", "device_loss@7:4",
         "replica_loss@3:1;kv_corrupt@3"]
BAD = ["bogus@1", "nan", "nan@x", "nan@1;nan@2"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_plan_matches_jax(spec):
    got, want = faults.parse_fault_plan(spec), jfaults.parse_fault_plan(spec)
    assert got.entries == want.entries and bool(got) == bool(want)
    for kind in faults.PLAN_KINDS:
        assert got.step(kind) == want.step(kind)


@pytest.mark.parametrize("spec", BAD)
def test_bad_fault_plans_refused_as_jax(spec):
    with pytest.raises(ValueError) as got:
        faults.parse_fault_plan(spec)
    with pytest.raises(ValueError) as want:
        jfaults.parse_fault_plan(spec)
    assert str(got.value) == str(want.value)


def test_fault_plan_env_helpers_match_jax(monkeypatch):
    for var in (faults.ENV_NAN_STEP, faults.ENV_ALLOC_STEP):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(faults.ENV_FAULT_PLAN,
                       "nan@3:layer1;alloc@5;preempt@9;device_loss@7:4")
    for mod in (faults, jfaults):
        assert mod.nan_step_from_env() == 3
        assert mod.nan_path_from_env() == "layer1"
        assert mod.alloc_step_from_env() == 5
        assert mod.preempt_step_from_env() == 9
        assert mod.device_loss_spec_from_env() == (7, 4)
    with pytest.raises(faults.SyntheticResourceExhausted):
        faults.inject_alloc_failure(5)
    faults.inject_alloc_failure(4)


@pytest.mark.parametrize("kind", ["replica_loss", "kv_corrupt"])
def test_one_shot_fleet_injectors_match_jax(kind, monkeypatch):
    """``replica_loss`` and ``kv_corrupt``: unarmed, armed through the API
    (fires once at its step, disarmed on exit) and armed through the plan
    (the replica defaults to 0): the same answers as JAX's, call for
    call."""
    def calls(mod):
        inject = getattr(mod, f"inject_{kind}")
        fires = getattr(mod, f"{kind}_for")
        disarm = getattr(mod, f"disarm_{kind}")
        monkeypatch.delenv(mod.ENV_FAULT_PLAN, raising=False)
        disarm()
        seen = [fires(0)]
        with inject(1, 6) as st:
            seen += [fires(5), fires(6), st["fired"], fires(6)]
        seen.append(fires(6))
        monkeypatch.setenv(mod.ENV_FAULT_PLAN, f"{kind}@2")
        disarm()
        seen += [fires(1), fires(2), fires(2)]
        disarm()
        return seen

    got = calls(faults)
    assert got == calls(jfaults)
    assert got == [None, None, 1, 1, None, None, None, 0, None]


def test_inject_nan_poisons_the_same_leaves():
    tree = {"layer0": {"w": np.ones((2, 3), np.float32)},
            "layer1": {"w": np.ones(4, np.float32),
                       "b": np.ones(2, np.float32)},
            "count": np.int32(3)}
    for filt in (None, "layer1", lambda p: p.endswith("/b")):
        want = jfaults.inject_nan(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.int32(5), nan_step=5, path_filter=filt)
        for step in (5, torch.tensor(5)):
            got = faults.inject_nan(
                jax.tree_util.tree_map(torch.as_tensor, tree), step,
                nan_step=5, path_filter=filt)
            for g, w in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        clean = faults.inject_nan(jax.tree_util.tree_map(torch.as_tensor,
                                                         tree), 4, nan_step=5)
        assert not any(torch.isnan(t).any() for t in
                       jax.tree_util.tree_leaves(clean)
                       if t.is_floating_point())


def test_classify_failure_on_the_ports_exceptions():
    assert classify_failure(NonFiniteError("x")) == FailureClass.NUMERICS
    assert classify_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory")) == FailureClass.OOM
    assert classify_failure(HBMExhaustedError("x")) == FailureClass.OOM
    assert classify_failure(faults.SyntheticResourceExhausted(
        "RESOURCE_EXHAUSTED: x")) == FailureClass.OOM
    assert classify_failure(checkpoint.CheckpointCorruptError("x")) == \
        FailureClass.CHECKPOINT
    assert classify_failure(faults.DeviceLostError("DEVICE_LOST: x")) == \
        FailureClass.DEVICE_LOSS
    assert classify_failure(ValueError("boom")) == FailureClass.UNKNOWN


PLANTED = [False, True, False, True, True, True, False]


def test_guard_counts_match_jax_over_a_planted_sequence():
    """The same poisoned/clean sequence through both guards: the same
    GuardState after every step, the same committed state, and
    check_guard escalating at the same step (3 in a row)."""
    def run(pkg_guard, check, arr, where, nan):
        gst = pkg_guard.init_guard_state()
        state = {"x": arr(0.0)}
        out = []
        for k, poison in enumerate(PLANTED):
            grads = {"w": arr(nan if poison else 1.0)}
            if pkg_guard is jguard:
                upd = lambda g, s: {"x": s["x"] + g["w"]}  # noqa: E731
            else:
                upd = lambda g, s, f: {"x": s["x"] + g["w"]}  # noqa: E731
            state, gst = pkg_guard.guarded_update(grads, upd, state, gst)
            try:
                check(gst, 3)
                esc = False
            except Exception as e:  # noqa: BLE001
                esc = type(e).__name__
            out.append(([int(v) for v in gst], float(state["x"]), esc))
        return out

    want = run(jguard, jguard.check_guard, lambda v: jnp.float32(v), None,
               np.nan)
    got = run(__import__("apex_tpu_torch.resilience.guard",
                         fromlist=["guard"]), check_guard,
              lambda v: torch.tensor(v), None, float("nan"))
    assert got == want
    assert [o[2] for o in got].index("NonFiniteError") == 5


def _gpt():
    torch.manual_seed(0)
    cfg = TransformerConfig(**GPT_KW, compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cpu")
    with torch.no_grad():
        init_weights(model, 0)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    model, opt = amp.initialize(model, opt, opt_level="O2", verbosity=0)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 256, (BATCH, SEQ)))
    labels = torch.from_numpy(rng.randint(0, 256, (BATCH, SEQ)))
    return model, opt, tokens, labels


def _snapshot(model, opt):
    out = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        st = opt.state[p]
        out += [st[k].clone() for k in sorted(st)]
    out += [torch.as_tensor(g["step"]).clone() for g in opt.param_groups]
    return out


def test_guarded_amp_step_skips_bit_for_bit_and_commits_after(tmp_path):
    model, opt, tokens, labels = _gpt()
    rec = FlightRecorder(length=4, prefix_depth=3)
    gst = init_guard_state()
    rstate = None
    counter = {"step": torch.zeros((), dtype=torch.int32)}
    scales = []
    for k, poison in enumerate([False, True, False]):
        opt.zero_grad()
        loss = gpt_loss_fn(model(tokens), labels)
        opt.scale_loss(loss).backward()
        _, found_inf = opt.unscale()
        grads = numerics.module_grads(model)
        if poison:  # one module's gradients poisoned in place
            for name, g in faults.inject_nan(
                    grads, k, nan_step=k,
                    path_filter="transformer/layers/1/mlp").items():
                grads[name].copy_(g)
        if rstate is None:
            rstate = rec.init_state(grads)
        before = _snapshot(model, opt)
        scale_before = float(opt.scaler._state.loss_scale)

        def opt_update(g, state, flag):
            opt.apply(flag)
            return {"step": state["step"] + 1}

        counter, gst, opt.scaler._state, rstate = guarded_update(
            grads, opt_update, counter, gst, found_inf=found_inf,
            scaler=opt.scaler, scaler_state=opt.scaler._state,
            recorder=rec, recorder_state=rstate, step=k)
        after = _snapshot(model, opt)
        same = all(torch.equal(a, b) for a, b in zip(before, after))
        assert same == poison, f"step {k}"
        scales.append(float(opt.scaler._state.loss_scale) / scale_before)
        if poison:
            check_guard(gst, recorder=rec, recorder_state=rstate,
                        postmortem_dir=str(tmp_path))
            post = rec.last_postmortem
            assert post["first_nonfinite_prefix"] == "transformer/layers/1"
            assert post["first_nonfinite_step"] == 1
    assert scales == [1.0, 0.5, 1.0]
    assert int(counter["step"]) == 2
    assert [int(v) for v in gst] == [0, 1, 0]
    assert int(opt.param_groups[0]["step"]) == 2


def test_preemption_guard_real_signal_and_handlers_restored():
    prev = signal.getsignal(signal.SIGTERM)
    saves = []
    with PreemptionGuard(final_save=lambda: saves.append(1)) as guard:
        assert not guard.should_checkpoint()
        faults.simulate_preemption()
        assert guard.preempted and guard.signum == signal.SIGTERM
        assert guard.should_checkpoint()
    assert saves == [1]
    assert signal.getsignal(signal.SIGTERM) is prev
    with PreemptionGuard(signals=()) as g2:
        g2.trigger()
        g2.mark_saved()
        assert not g2.should_checkpoint()
