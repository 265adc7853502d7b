"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into ``_build/`` (listed in
``.gitignore``) under a name that hashes the source and the flags, so an
edited source rebuilds and an unchanged one is reused. The library is written
to a temporary name and moved into place with ``os.replace``; no lock file is
used, so a build cut off half way leaves nothing that blocks the next one.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300

_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float (0.0 when reused), "ptxas": [str], "path": str}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _ptxas_summary(stderr: str) -> list[str]:
    keep = ("registers", "spill", "Compiling entry")
    return [ln.strip() for ln in stderr.splitlines() if any(k in ln for k in keep)]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    if name in _libs:
        return _libs[name]
    src = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{name}_{digest}.so"
    info = {"seconds": 0.0, "ptxas": [], "path": str(so)}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s on {src}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = _ptxas_summary(proc.stderr)
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    build_info[name] = info
    return lib
