"""The host track generator in C++ (``csrc/trackgen.cpp``), loaded with ctypes.

``csrc/trackgen.cpp`` is the port's own copy of the JAX package's native
generator: the reference's track walk (mcr:183-338) with a numpy
``RandomState``-compatible MT19937, bit-exact with ``track/host.py``. The
caller's MT state goes in and comes back through ``RandomState.get_state`` /
``set_state``, so the stream continues bit for bit, as when Python and C++
draw in turn from one shared ``np_random``.

The library is built with the host compiler at first use into ``_build/``
(listed in ``.gitignore``) under a name that hashes the source and the flags,
written to a temporary name and moved into place with ``os.replace``, so
several processes that build at once cannot break each other. Nothing is
built at import. There is no fallback: when the build fails, ``load``
returns None, ``build_error`` gives the compiler's message, and
``generate_track`` raises with it. ``track/host.generate_track`` stays the
plain version that the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "trackgen.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
# No contraction of a*b+c into an FMA: the walk must round as Python's does.
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")
BUILD_TIMEOUT_S = 120
MAX_POINTS = 2500                 # the walk's bound, the output's capacity

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> Path:
    """The library's path, compiling it if it is not there; raises
    RuntimeError with the compiler's output when the build fails."""
    src = Path(SOURCE)
    h = hashlib.sha256(src.read_bytes() if src.exists() else str(src).encode())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    so = BUILD_DIR / f"trackgen_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)}: {type(e).__name__}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load():
    """The native library, building it if needed; None if the build failed
    (``build_error`` then says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            return None
        lib.mcr_generate_track.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mcr_generate_track.restype = ctypes.c_int
        _lib = lib
        return _lib


def build_error() -> str | None:
    return _build_error


def generate_track(rng: np.random.RandomState, max_retries: int = 100):
    """``track.host.generate_track`` on the native core.

    Consumes and advances ``rng``'s MT19937 state exactly as the Python walk
    does (bit-exact tracks and stream continuation). Returns (track (T, 4)
    float64, border (T,) bool, retries); raises RuntimeError if the library
    did not build (with the compiler's message) or every retry failed.
    ``generate_track.calls`` counts the calls that reached the library."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native track generator unavailable: {_build_error}")

    kind, keys, pos, has_gauss, cached = rng.get_state()
    if kind != "MT19937":
        raise ValueError(f"native track generator: a {kind} stream, expected MT19937")
    state = np.ascontiguousarray(keys, dtype=np.uint32)
    pos_c = ctypes.c_int(int(pos))
    out_track = np.empty((MAX_POINTS, 4), np.float64)
    out_border = np.empty(MAX_POINTS, np.uint8)
    retries = ctypes.c_int(0)

    generate_track.calls += 1
    t = lib.mcr_generate_track(
        state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(pos_c),
        max_retries,
        out_track.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_border.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(retries),
    )
    # The stream advances on failure too, as the Python walk's does.
    rng.set_state((kind, state, int(pos_c.value), has_gauss, cached))
    if t <= 0:
        raise RuntimeError(f"track generation failed {max_retries} times")
    return out_track[:t].copy(), out_border[:t].astype(bool), int(retries.value)


generate_track.calls = 0
