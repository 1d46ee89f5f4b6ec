"""apex_tpu_torch's kernel build (kernels/_build) and launch counters
(kernels/registry), on the CPU.

There is no nvcc here, so a stand-in compiler (a shell script that
writes its ``-o`` file, or one that fails) takes its place; what is
tested is the build's bookkeeping: one library per source named by the
sources' hash, a rebuild when a source changes, a failure that raises
with the compiler's output, and nothing built at import.
"""

import stat
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.kernels import _build, registry
from torch_threads import one_torch_thread  # noqa: F401

_FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "compiled $out"
printf lib > "$out"
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A csrc/ with two sources and an empty build dir, and a stand-in
    nvcc that succeeds."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "shared.cuh").write_text("// shared\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    _build._digest.cache_clear()
    yield csrc
    _build._digest.cache_clear()


def test_build_all_builds_each_source_once(tree):
    log = _build.build_all()
    built = sorted(p.name for p in _build.BUILD_DIR.iterdir())
    digest = _build._digest()
    assert built == [f"a-{digest}.so", f"b-{digest}.so"]
    assert "== a.cu" in log and "== b.cu" in log
    assert _build.build_all() == ""  # nothing left to build


def test_a_changed_header_rebuilds_every_library(tree):
    _build.build_all()
    old = _build.library_path("a")
    (tree / "shared.cuh").write_text("// shared, edited\n")
    _build._digest.cache_clear()
    assert _build.library_path("a") != old
    assert not _build.library_path("a").exists()
    _build.build_all()
    assert _build.library_path("a").exists()
    assert _build.library_path("b").exists()


def test_failed_build_raises_with_compiler_output(tree, monkeypatch,
                                                  tmp_path):
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                   "exit 3\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(bad))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build_all()
    assert not any(_build.BUILD_DIR.glob("*.so"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_real_sources_and_flags():
    names = {p.name for p in _build.sources()}
    assert {"adam.cu", "flash_attention.cu", "gqa_decode.cu", "lamb.cu",
            "layer_norm.cu", "mla_decode.cu", "rms_norm.cu", "softmax.cu",
            "window_attention.cu"} <= names
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert _build.BUILD_DIR == (Path(__file__).resolve().parents[1]
                                / "build" / "apex_tpu_torch")


def test_plain_versions_count_no_launch():
    """CPU tensors take the plain versions, which are not launches."""
    from apex_tpu_torch.contrib import gqa_decode
    from apex_tpu_torch.kernels import fused_cc, norm, optim, softmax
    registry.reset()
    q = torch.randn(2, 1, 2, 2, 16)
    k = torch.randn(8, 1, 2, 16)
    x = torch.randn(3, 16)
    norm.rms_fwd(x, None, 1e-5)
    norm.rms_bwd_dx(x, x, None, 1e-5)
    fused_cc.window_attention(q, k, k, 0, 0.25)
    gqa_decode.gqa_flash_decode(q[0], k, k, 3, 0.25)
    y = softmax.causal_softmax_fwd(x[None], 1.0)
    softmax.softmax_bwd(y, y, 1.0)
    optim.adam(torch.zeros(1), [x], [x.clone()], [x.clone()], [x.abs()],
               lr=1e-3, bc1=0.1, bc2=0.001, b1=0.9, b2=0.999, eps=1e-8,
               weight_decay=0.0, adam_w=True)
    norm.ln_fwd(x, None, None, 1e-5)
    norm.ln_bwd_dx(x, x, None, 1e-5)
    softmax.scaled_softmax_fwd(x, 1.0)
    softmax.scaled_masked_softmax_fwd(x, x > 0, 1.0)
    optim.lamb(torch.zeros(1), [x.clone()], [x], [x.clone()], [x.abs()],
               clip=None, bc1=0.1, bc2=0.001, b1=0.9, b2=0.999, beta3=0.1,
               eps=1e-6, weight_decay=0.0, adam_w=True)
    kernels = ("rms_norm", "rms_bwd", "window_attention", "gqa_decode",
               "causal_softmax", "softmax_bwd", "adam", "layer_norm",
               "ln_bwd", "scaled_softmax", "masked_softmax", "lamb")
    launches = registry.launches()
    assert set(kernels) <= launches.keys()
    assert not any(launches[name] for name in kernels), launches


def test_registry_counts_and_resets():
    name = registry.register("test_only_kernel")
    try:
        registry.count(name)
        registry.count(name)
        assert registry.launches()[name] == 2
        registry.reset()
        assert registry.launches()[name] == 0
    finally:
        registry._launches.pop(name)


def test_import_loads_no_library():
    """Importing every module of the package builds and loads nothing:
    a library is built and loaded at a kernel's first launch."""
    import apex_tpu_torch.models  # noqa: F401  (imports every kernel module)
    assert _build._libs == {}
