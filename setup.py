"""Build: pure-Python package + the apex_tpu_C native runtime extension.

The reference gates its native layer behind install flags
(reference setup.py:103-758, --cpp_ext/--cuda_ext); here the single C++
extension builds everywhere a C++17 compiler exists and the Python layer
falls back to numpy paths when it is absent
(apex_tpu/_C.py lazy import).

    pip install -e .                 # with the native extension
    APEX_TPU_NO_EXT=1 pip install -e .   # Python-only build
"""

import os

from setuptools import Extension, find_packages, setup

ext_modules = []
if not os.environ.get("APEX_TPU_NO_EXT"):
    ext_modules.append(
        Extension(
            "apex_tpu_C",
            sources=["csrc/apex_tpu_C.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
        ))

setup(
    name="apex_tpu",
    version="0.1.0",
    description="TPU-native mixed-precision and model-parallel training "
                "framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["apex_tpu", "apex_tpu.*",
                                    "apex_tpu_torch", "apex_tpu_torch.*"]),
    # the PyTorch port's CUDA sources, compiled with nvcc at first use
    package_data={"apex_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=ext_modules,
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy", "einops"],
    # pytest.ini sets "-n auto", so the suite needs xdist present
    extras_require={"test": ["pytest", "pytest-xdist", "optax", "orbax",
                             "chex", "torch", "transformers"]},
)
