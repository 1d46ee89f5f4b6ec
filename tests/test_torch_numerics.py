"""apex_tpu_torch.telemetry.numerics and .recorder against the JAX
package's on the CPU, and the host side of K7 (kernels/stats.py).

- ``tree_stats`` / ``tensor_stats`` on seeded trees holding NaN, Inf,
  exact zeros, values past fp16's and bf16's ranges, and fp16 and bf16
  leaves: the keys, the non-finite and range counts (as fractions) and
  absmax exact, the sums of squares (l2, rms) within 1e-6 relative
  (fp32 sums in another order).
- The flight recorder: the same records give the same fetched rows and
  the same post-mortem (first non-finite step and prefix).
- K7's plain version (the path CPU tensors take) against a float64
  count of the same quantities; group folds in leaf order; the kernel's
  scratch size and its ctypes signature against the C definition
  (nothing is built).
"""

import ctypes
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.telemetry import numerics as jnum
from apex_tpu.telemetry import recorder as jrec
from apex_tpu_torch.kernels import _build
from apex_tpu_torch.kernels import stats as k7
from apex_tpu_torch.telemetry import numerics as tnum
from apex_tpu_torch.telemetry import recorder as trec
from torch_threads import one_torch_thread  # noqa: F401

SUMSQ_RTOL = 1e-6


def _tree(seed, poison=True):
    """A nested tree of numpy leaves with every range case in it."""
    rng = np.random.RandomState(seed)
    big = rng.randn(300).astype(np.float32) * 3e4       # some past fp16 max
    big[:5] = 0.0
    tiny = (rng.rand(257) * 1e-4).astype(np.float32)    # fp16 underflows
    tiny[-3:] = 1e-39                                    # fp32 subnormals
    w = rng.randn(33, 17).astype(np.float32)
    if poison:
        w[3, 4] = np.nan
        w[7, 0] = np.inf
        big[10] = -np.inf
    huge = np.array([3.4e38, -3.39e38, 1.0, 0.0], np.float32)  # past bf16
    return {
        "encoder": {"layer_0": {"w": w, "b": big},
                    "layer_1": {"w": tiny, "bias": huge}},
        "head": [rng.randn(40).astype(np.float16),
                 (rng.randn(65) * 1e-3).astype(ml_dtypes.bfloat16)],
        "step": np.int32(7),
    }


def _to_torch(tree):
    def conv(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(conv, tree)


def _jax_floats(stats):
    return {k: {f: float(getattr(v, f)) for f in jnum.STAT_FIELDS}
            for k, v in stats.items()}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        for f in jnum.STAT_FIELDS:
            g, w = got[key][f], want[key][f]
            if f in ("l2", "rms"):
                assert g == pytest.approx(w, rel=SUMSQ_RTOL), (key, f)
            else:
                np.testing.assert_equal(g, w, err_msg=f"{key} {f}")


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_stats_match_jax(depth, seed):
    tree = _tree(seed)
    want = _jax_floats(jnum.tree_stats(
        jax.tree_util.tree_map(jnp.asarray, tree), depth, prefix="grads"))
    got = tnum.stats_to_floats(tnum.tree_stats(_to_torch(tree), depth,
                                               prefix="grads"))
    _same(got, want)
    assert tnum.first_nonfinite_prefix(got) == \
        jnum.first_nonfinite_prefix(want)


def test_tensor_stats_match_jax_per_dtype():
    for leaf in jax.tree_util.tree_leaves(_tree(2)):
        a = np.asarray(leaf)
        if not np.issubdtype(a.dtype, np.floating) and \
                a.dtype != ml_dtypes.bfloat16:
            with pytest.raises(TypeError):
                tnum.tensor_stats(_to_torch(a))
            continue
        want = jnum.tensor_stats(jnp.asarray(leaf))
        got = tnum.tensor_stats(_to_torch(a))
        _same({"x": {f: float(getattr(got, f)) for f in tnum.STAT_FIELDS}},
              {"x": {f: float(getattr(want, f)) for f in jnum.STAT_FIELDS}})


def test_stats_table_layout_and_merge():
    tree = _to_torch(_tree(3, poison=False))
    s = tnum.tree_stats(tree, 2, prefix="grads")
    assert s.table.shape == (len(s), 9) and list(s) == sorted(s)
    for i, key in enumerate(s):
        assert torch.equal(torch.stack(list(s[key])), s.table[i])
    merged = tnum.merge(s, tnum.tree_stats(tree, 1, prefix="synced"))
    assert list(merged) == sorted(merged)
    assert tnum.stats_to_floats(merged)["grads/head/0"] == \
        tnum.stats_to_floats(s)["grads/head/0"]
    assert tnum.first_nonfinite_prefix(tnum.stats_to_floats(merged)) is None


def test_k7_plain_version_counts_in_float64():
    rng = np.random.RandomState(4)
    xs = [rng.randn(5000).astype(np.float32) * 1e5,
          (rng.randn(777) * 1e-20).astype(np.float32)]
    xs[0][[3, 9]] = [np.nan, -np.inf]
    xs[0][100:120] = 0.0
    ts = [torch.from_numpy(x) for x in xs] + [
        torch.from_numpy(xs[0]).to(torch.float16),
        torch.from_numpy(xs[1]).to(torch.bfloat16)]
    sums, counts = k7.multi_tensor_stats(ts, [0, 1, 0, 1], 2)
    want_counts = np.zeros((2, 6), np.int64)
    want_ss = [0.0, 0.0]
    want_max = [0.0, 0.0]
    for t, g in zip(ts, [0, 1, 0, 1]):
        x = t.double().numpy()
        fin = np.isfinite(x)
        a = np.where(fin, np.abs(x), 0.0)
        a = np.where(a < k7.BF16_TINY, 0.0, a)  # fp32 subnormals flushed
        want_counts[g] += [
            (fin & (a == 0)).sum(), (~fin).sum(), (a > k7.FP16_MAX).sum(),
            ((a > 0) & (a < k7.FP16_TINY)).sum(), (a > k7.BF16_MAX).sum(),
            ((a > 0) & (a < k7.BF16_TINY)).sum()]
        want_ss[g] += float((a * a).sum())
        want_max[g] = max(want_max[g], float(a.max()))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(sums[:, 1].numpy(),
                                  np.float32(want_max))
    np.testing.assert_allclose(sums[:, 0].numpy(), want_ss, rtol=1e-5)
    assert counts.dtype == torch.int64 and sums.dtype == torch.float32


def test_k7_scratch_and_launch_split():
    assert k7.CHUNK == 65536 and k7.WORDS == 8
    assert k7.scratch_words([1, 65536, 65537]) == 8 * (1 + 1 + 2) + 9 * 3 + 1
    assert k7.work([torch.zeros(10), torch.zeros(3, dtype=torch.bfloat16)]
                   ) == (26.0, 46.0)
    with pytest.raises(ValueError, match="group ids"):
        k7.multi_tensor_stats([torch.zeros(2)], [3], 2)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        k7.multi_tensor_stats([torch.zeros(2, dtype=torch.float64)])


def test_k7_ctypes_signature_matches_the_c_function(monkeypatch):
    src = (Path(_build.__file__).resolve().parent.parent / "csrc"
           / "stats.cu").read_text()
    params = re.search(r'extern "C" int apex_multi_tensor_stats\(([^)]*)\)',
                       src).group(1)
    want = []
    for param in params.split(","):
        param = " ".join(param.split())
        if "*" in param:
            want.append(ctypes.c_void_p)
        else:
            want.append({"int": ctypes.c_int, "long long": ctypes.c_longlong}[
                param.rsplit(" ", 1)[0].removeprefix("const ")])
    seen = {}
    monkeypatch.setattr(_build, "function",
                        lambda lib, sym, argtypes: seen.update(
                            lib=lib, sym=sym, argtypes=list(argtypes)))
    k7._kernel.cache_clear()
    try:
        k7._kernel()
    finally:
        k7._kernel.cache_clear()
    assert seen["lib"] == "stats" and seen["argtypes"] == want
    # the source's constants are the wrapper's
    assert "constexpr int kThreads = 256;" in src
    assert "constexpr int kPer = 8;" in src
    assert "constexpr int kBatches = 32;" in src
    assert "constexpr int kMaxTensors = 64;" in src


def test_flight_recorder_matches_jax(tmp_path):
    rows_by = []
    for pkg, num, conv in ((jrec, jnum, lambda t: jax.tree_util.tree_map(
            jnp.asarray, t)), (trec, tnum, _to_torch)):
        rec = pkg.FlightRecorder(length=3, prefix_depth=2)
        state = rec.init_state(conv(_tree(0)))
        for step, seed, poison in ((0, 5, False), (1, 6, False),
                                   (2, 7, True), (3, 8, False)):
            st = num.tree_stats(conv(_tree(seed, poison)), 2)
            state = rec.record(state, step, st)
        d = tmp_path / pkg.__name__.split(".")[0]
        post = rec.dump_postmortem(state, str(d), reason="step_skipped")
        assert post["path"] is not None
        rows_by.append((rec.fetch(state), post))
    (rows_t, post_t), (rows_j, post_j) = rows_by[1], rows_by[0]
    assert [r["step"] for r in rows_t] == [r["step"] for r in rows_j] == \
        [1, 2, 3]
    for rt, rj in zip(rows_t, rows_j):
        _same(rt["stats"], rj["stats"])
    for key in ("first_nonfinite_step", "first_nonfinite_prefix",
                "ring_length", "prefix_depth", "reason", "rank"):
        assert post_t[key] == post_j[key], key
    assert post_t["first_nonfinite_step"] == 2
    on_disk = json.loads(Path(post_t["path"]).read_text())
    assert on_disk["first_nonfinite_prefix"] == \
        post_t["first_nonfinite_prefix"]
