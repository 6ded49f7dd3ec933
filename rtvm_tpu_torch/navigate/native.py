"""ctypes bindings for the port's host C++ (``csrc_host/``): the A* router
(``astar.cpp``, a copy of the JAX package's ``native/astar.cpp``) and the
contour, distance-transform and watershed code of ``utils/contours.py``
(``contours.cpp``). The counterpart of ``rtvm_tpu/navigate/native.py``.

The sources go through one ``g++ -O3 -shared -fPIC`` call into
``_build/librtvm_host_<hash>.so`` at first use, never at import
(``kernels.NativeLibrary``, which builds the CUDA kernels too); a stale
library is never reused. ``calls`` counts the router's calls, so that a run
can show that the native route ran.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from rtvm_tpu_torch.kernels import NativeLibrary

FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

calls = {"astar": 0}

_build_error: Optional[str] = None


def _declare(lib: ctypes.CDLL) -> None:
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


HOST = NativeLibrary("librtvm_host", Path(__file__).resolve().parents[1] / "csrc_host", "*.cpp",
                     "g++", FLAGS, declare=_declare)
build, library_path, library = HOST.build, HOST.path, HOST.load


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
