"""Package build (reference: ``setup.py`` + ``build_pip_pkg.sh``).

The TPU build has no CUDA compilation step; the optional native data-loader
extension under ``cc/`` builds with ``make -C cc`` (see Makefile) and is
loaded via ctypes with a pure-python fallback, so the wheel works without it.
"""

import os
import shutil
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

HERE = os.path.dirname(os.path.abspath(__file__))


def read_version():
    scope = {}
    with open(os.path.join(HERE, "distributed_embeddings_tpu", "version.py"),
              encoding="utf-8") as f:
        exec(f.read(), scope)  # noqa: S102 - own file
    return scope["__version__"]


class build_py_with_native(build_py):
    """Build and ship the native data-IO library inside the wheel.

    The reference wheel carries its compiled custom-op library
    (``build_pip_pkg.sh`` + ``setup.py:52-60``); here the native piece is
    ``cc/libdetpu_dataio.so``, staged into ``distributed_embeddings_tpu/
    utils/`` where ``utils/native.py`` looks for it. Best-effort: without a
    C++ toolchain the wheel still builds and every native entry point falls
    back to numpy."""

    def run(self):
        so = os.path.join(HERE, "cc", "libdetpu_dataio.so")
        try:
            subprocess.run(["make", "-C", os.path.join(HERE, "cc")],
                           check=True)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"[setup.py] native build skipped ({e}); "
                  "wheel will use the numpy fallbacks")
        if os.path.exists(so):
            shutil.copy2(so, os.path.join(
                HERE, "distributed_embeddings_tpu", "utils",
                "libdetpu_dataio.so"))
        super().run()


setup(
    name="distributed-embeddings-tpu",
    version=read_version(),
    description=("TPU-native large-embedding recommender training: "
                 "hybrid model/data-parallel embedding layers on JAX/XLA"),
    packages=find_packages(exclude=("tests", "examples")),
    # distributed_embeddings_torch (the PyTorch/CUDA port) ships its CUDA
    # sources; they are compiled with nvcc at first use on the GPU
    package_data={"distributed_embeddings_tpu.utils": ["*.so"],
                  "distributed_embeddings_torch": ["csrc/*.cu"]},
    cmdclass={"build_py": build_py_with_native},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={"torch": ["torch", "numpy"]},
)
