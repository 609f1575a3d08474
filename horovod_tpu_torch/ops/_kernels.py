"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with
:mod:`ctypes`. Nothing is built when this module is imported: the first
call that needs a kernel builds every source not yet built, one ``nvcc``
each, in parallel (a training step needs the flash forward's and
backward's libraries together). The output lands under
``build/horovod_tpu_torch/`` beside the package (ignored by git), named
by a hash of the sources and flags, so an edited source never loads a
stale library. Every build runs under one file lock beside that
directory (``build/horovod_tpu_torch.lock``), so processes of one
checkout that start together (a fleet's workers) build each library
once: the others wait and load it. A builder writes to a temporary
name and renames it into place.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together; :func:`ptxas_report` and :func:`ptxas_warnings` read
the compiler's ``-Xptxas -v`` log it returns.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "horovod_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build horovod_tpu_torch's kernels")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by a hash of the
    source, every header under ``csrc/`` and the compiler flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, force: bool = False):
    out = library_path(name)
    if out.exists() and not force:
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


@contextlib.contextmanager
def _build_lock():
    """The build directory's file lock, held while a process checks for
    a library and builds it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR.parent / f"{BUILD_DIR.name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        yield


def build_all(force: bool = False) -> Dict[str, str]:
    """Build every kernel source that is not built yet (every source
    with ``force``), one ``nvcc`` per source running in parallel.
    Returns each source's compiler log (``-Xptxas -v``: registers,
    shared memory, spills); empty for a library that was already
    built."""
    with _build_lock():
        jobs = {name: _start(name, force) for name in _sources()}
        logs, errors = {}, []
        # Wait for every nvcc, even after one fails.
        for name, job in jobs.items():
            try:
                logs[name] = _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?, (\d+) bytes smem)?")


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (by mangled name) in an ``-Xptxas -v`` log: its
    registers, spill stores and loads, and static shared memory, in
    bytes (dynamic shared memory is set at launch and not listed)."""
    kernels, name = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            kernels[name] = {"registers": 0, "spill_stores": 0,
                             "spill_loads": 0, "smem": 0}
        elif name and (m := _SPILLS.search(line)):
            kernels[name]["spill_stores"] = int(m.group(1))
            kernels[name]["spill_loads"] = int(m.group(2))
        elif name and (m := _USED.search(line)):
            kernels[name]["registers"] = int(m.group(1))
            kernels[name]["smem"] = int(m.group(2) or 0)
    return kernels


def ptxas_warnings(log: str) -> List[str]:
    """The log's lines that say code generation lost what the source
    asked for: ``setmaxnreg`` ignored (C7508), or ``wgmma`` serialised."""
    return [line.strip() for line in log.splitlines()
            if "C7508" in line or "wgmma.mma_async instructions are "
                                  "serialized" in line]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with every other source not yet built (:func:`build_all`)."""
    build_all()
    return ctypes.CDLL(str(library_path(name)))
