"""Build and load the port's CUDA kernels (``csrc/*.cu``).

All sources go through ONE ``nvcc`` call into one shared library with a plain
C interface, built at first use into ``_build/`` (listed in ``.gitignore``)
under a name keyed by a hash of the sources and flags, and loaded with
ctypes. ``torch.utils.cpp_extension`` is not used: its builds include
PyTorch's headers and take minutes, where this one takes seconds.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. The build runs with
``-Xptxas -v``; nvcc's stderr is kept beside the library (``.log``), and
``ptxas_summary`` reads each kernel's registers, shared memory and spills
from it. The wrappers that call
these entry points live beside their plain PyTorch versions
(``ops/pallas_warp.py``, ``ops/pallas_patches.py``, ``ops/warp.py``) and
count their launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("warp.cu", "patches.cu", "union.cu", "weight.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launch counts, one plain integer per kernel. A wrapper adds one exactly
# where it launches its kernel; chip_smoke.py zeroes them before driving the
# main path and reads them after.
launches = {"warp": 0, "patches": 0, "union": 0, "weight": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librtvm_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the sources if this hash has not been built yet; returns the
    library's path. nvcc's stderr goes to ``build_log()``'s file. Raises with
    that stderr when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


def build_log() -> str:
    """nvcc's stderr from the build of the current sources ('' if none)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_summary(log: str) -> dict:
    """Per kernel (``__global__`` entry), from ``-Xptxas -v`` output:
    registers, static shared memory, stack frame, spill store and load bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "smem": 0, "stack": 0, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["stack"], out[name]["spill_stores"], out[name]["spill_loads"] = (
                int(m.group(1)), int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(m.group(1)) if m else 0
            name = None
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.rtvm_warp_bilinear.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
            lib.rtvm_warp_bilinear.restype = i
            lib.rtvm_extract_patches_octaves.argtypes = [i, p, i, p, p]
            lib.rtvm_extract_patches_octaves.restype = i
            f = ctypes.c_float
            lib.rtvm_union_distance.argtypes = [p, p, p, i, i, i, f, f, f, p]
            lib.rtvm_union_distance.restype = i
            lib.rtvm_frame_weight.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, f, f, f, p]
            lib.rtvm_frame_weight.restype = i
            _lib = lib
        return _lib


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device. The same
    as ``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object (about 10 us a call on the card's host)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
