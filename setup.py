"""Packaging: `pip install .` builds the native coordination core and
installs the `horovodrun` console script (the reference's setup.py
drives CMake the same way; our native build is a plain Makefile)."""

import subprocess
import sys
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

ROOT = Path(__file__).parent


class BuildNativeThenPy(build_py):
    def run(self):
        subprocess.check_call(["make", "-C", str(ROOT / "native")])
        lib = ROOT / "native" / "libhorovod_tpu_core.so"
        target_pkg = ROOT / "horovod_tpu" / "common"
        # Ship the shared library inside the package so ctypes finds it
        # without the source tree (basics.py checks the package dir
        # first, then the native/ build tree).
        if lib.exists():
            import shutil
            shutil.copy2(lib, target_pkg / lib.name)
        super().run()


setup(
    name="horovod-tpu",
    version="0.1.0",
    description=("TPU-native distributed training framework with "
                 "Horovod's product surface"),
    python_requires=">=3.10",
    # horovod_tpu_torch is the PyTorch/CUDA port; its kernels are built
    # from the shipped csrc/*.cu sources at first use.
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    package_data={"horovod_tpu.common": ["libhorovod_tpu_core.so"],
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    install_requires=["numpy", "cloudpickle", "pyyaml"],
    extras_require={
        # >=0.6 has the modern surface (lax.pcast, shard_map
        # axis_names); common/jax_compat.py translates down to 0.4.x
        # (experimental shard_map, no VMA types) with reduced coverage
        # for the Pallas and partial-manual island paths.
        "jax": ["jax>=0.4.30", "optax"],
        "torch": ["torch"],
        "ray": ["ray"],
        "spark": ["pyspark"],
    },
    entry_points={
        "console_scripts": [
            "horovodrun = horovod_tpu.runner.launch:main",
        ],
    },
    cmdclass={"build_py": BuildNativeThenPy},
)
