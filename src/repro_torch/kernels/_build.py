"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. At first
use ``load(name)`` compiles it with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` (beside this file; the directory is not
committed), named by a hash of the source and the flags, and opens it with
``ctypes``. A library already built from the same source is reused.
``build_all`` starts one nvcc per source, all together. A failed build
raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           f"({home}); the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to (keyed by source and flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    return build_all([name])[name]


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built
    yet, one nvcc process per source, all started together. Returns
    {name: library path}; raises with nvcc's output if any build fails
    (after every started nvcc has ended)."""
    outs = {name: library_path(name) for name in names}
    todo = {n: p for n, p in outs.items() if not p.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name} (exit "
                          f"{proc.returncode}):\n{stderr}{stdout}")
        else:
            os.replace(tmp, todo[name])   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, opened once per process."""
    return ctypes.CDLL(str(build(name)))
