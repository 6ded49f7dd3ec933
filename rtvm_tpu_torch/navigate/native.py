"""ctypes bindings for the port's host C++ (``csrc_host/``): the A* router
(``astar.cpp``, a copy of the JAX package's ``native/astar.cpp``) and the
contour, distance-transform and watershed code of ``utils/contours.py``
(``contours.cpp``). The counterpart of ``rtvm_tpu/navigate/native.py``.

Both sources go through one ``g++ -O3 -shared -fPIC`` call into
``_build/`` (listed in ``.gitignore``) under a name keyed by a hash of the
sources and flags, at first use, never at import; a stale library is never
reused. ``calls`` counts the router's calls, so that a run can show that
the native route ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

PKG = Path(__file__).resolve().parents[1]
SRC_DIR = PKG / "csrc_host"
BUILD_DIR = PKG / "_build"
SOURCES = ("astar.cpp", "contours.cpp")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

calls = {"astar": 0}

_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"librtvm_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if this hash has not been built yet; returns the
    library's path. Raises with g++'s stderr when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *FLAGS, "-o", str(tmp), *[str(SRC_DIR / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.astar_grid.restype = i
            lib.astar_grid.argtypes = [p, i, i, i, i, i, i, p, i]
            lib.rtvm_external_contours.restype = i
            lib.rtvm_external_contours.argtypes = [p, i, i, ctypes.POINTER(p),
                                                   ctypes.POINTER(i64), ctypes.POINTER(p)]
            lib.rtvm_free.restype = None
            lib.rtvm_free.argtypes = [p]
            lib.rtvm_distance_l2_5x5.restype = None
            lib.rtvm_distance_l2_5x5.argtypes = [p, i, i, p]
            lib.rtvm_watershed.restype = None
            lib.rtvm_watershed.argtypes = [p, i, i, p]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (the A* router falls back
    to Python when it does not, as the JAX package's does)."""
    global _build_error
    if _build_error is not None:
        return False
    try:
        library()
        return True
    except (OSError, RuntimeError) as e:
        _build_error = str(e)
        return False


def astar_native(grid: np.ndarray, start: Tuple[int, int],
                 goal: Tuple[int, int]) -> Optional[List[Tuple[int, int]]]:
    """8-connected A* on a bool grid (True = blocked), start and goal as
    (row, col). Returns the cell path or None."""
    lib = library()
    g = np.ascontiguousarray(grid, dtype=np.uint8)
    h, w = g.shape
    out = np.zeros((h * w, 2), np.int32)
    calls["astar"] += 1
    n = lib.astar_grid(g.ctypes.data, h, w, int(start[0]), int(start[1]), int(goal[0]),
                       int(goal[1]), out.ctypes.data, h * w)
    if n <= 0:
        return None
    return [tuple(int(v) for v in p) for p in out[:n]]
