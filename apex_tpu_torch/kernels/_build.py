"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``apex_tpu_torch/csrc/<name>.cu`` becomes a shared library with a
plain C interface, ``build/apex_tpu_torch/<name>-<hash>.so`` at the root
of the checkout, compiled for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/apex_tpu_torch/<name>-<hash>.so <name>.cu

The hash covers every file under ``csrc/`` (the kernels share a header)
and the flags, so an edited source is rebuilt and a stale library is
never loaded. A library is built at first use; :func:`build_all` starts
one nvcc per missing library, all at once, and waits for every one of
them. A failed build raises with the compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled with the CUDA toolkit at first "
        "use")


def sources():
    """The kernel sources, one library each."""
    return sorted(CSRC.glob("*.cu"))


@functools.lru_cache(maxsize=1)
def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all(ptxas_verbose: bool = False) -> str:
    """Compile every source whose library is missing, one nvcc each, all
    started together. Returns the compilers' output (with
    ``ptxas_verbose``, each kernel's registers and shared memory)."""
    with _lock:
        todo = [s for s in sources() if not library_path(s.stem).exists()]
        if not todo:
            return ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        extra = ("-Xptxas", "-v") if ptxas_verbose else ()
        compiler = nvcc()
        jobs = []
        for src in todo:
            out = library_path(src.stem)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
            jobs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return "\n".join(logs)


def function(lib_name: str, symbol: str, argtypes):
    """The C function ``symbol`` of library ``lib_name`` (built if
    missing), with its argument types set; it returns an int status."""
    with _lock:
        lib = _libs.get(lib_name)
    if lib is None:
        path = library_path(lib_name)
        if not path.exists():
            build_all()
        with _lock:
            lib = _libs.setdefault(lib_name, ctypes.CDLL(str(path)))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
