"""Build, load and launch the port's native code.

``NativeLibrary`` builds the sources of one directory with ONE compiler call
into one shared library with a plain C interface, at first use, never at
import: ``_build/<stem>_<hash>.so`` (``_build/`` is listed in ``.gitignore``),
keyed by a hash of the sources and flags, with the compiler's stderr kept
beside it (``.log``), and loads it once with ctypes. Two libraries go through
it: the CUDA kernels (``csrc/*.cu``, nvcc, ``library()`` here) and the host
C++ (``csrc_host/*.cpp``, g++, ``navigate/native.py``).
``torch.utils.cpp_extension`` is not used: its builds include PyTorch's
headers and take minutes, where these take seconds.

A CUDA entry point is declared once, as an ``Entry`` beside the wrapper that
calls it (``ops/kernel_warp.py``, ``ops/kernel_patches.py``, ``ops/warp.py``):
its C name, its argument types and the codes it returns besides CUDA's own.
Each entry returns ``cudaGetLastError()`` after its launch; calling the
``Entry`` appends PyTorch's current stream, raises on a non-zero code and
counts the launch in ``launches``. So a new kernel is its ``.cu`` file, its
wrapper and its tests.

The kernels build with ``-Xptxas -v``; ``ptxas_summary`` reads each kernel's
registers, shared memory and spills from the build's log.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches by kernel name. An Entry adds one exactly where it launches;
# chip_smoke.py zeroes them before driving the main path and reads them after.
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    """nvcc of the CUDA toolkit (CUDA_HOME, CUDA_PATH or /usr/local/cuda) if
    it is there, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


class NativeLibrary:
    """The sources of `src` that `pattern` matches, compiled by `compiler`
    (a path, or a name on PATH) with `flags` into
    ``BUILD_DIR/<stem>_<hash>.so``; `declare(lib)` runs once after loading
    (a host library's argument types)."""

    def __init__(self, stem: str, src: Path, pattern: str, compiler: str, flags, declare=None):
        self.stem, self.src, self.pattern = stem, Path(src), pattern
        self.compiler, self.flags, self.declare = compiler, tuple(flags), declare
        self._lib = None
        self._lock = threading.Lock()

    def sources(self) -> list:
        return sorted(self.src.glob(self.pattern))

    def path(self) -> Path:
        h = hashlib.sha256()
        for s in self.sources():
            h.update(s.name.encode())
            h.update(s.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the sources if this hash has not been built yet; returns
        the library's path. Raises with the compiler's stderr when it fails."""
        out = self.path()
        if out.exists():
            return out
        exe = shutil.which(self.compiler)
        if exe is None:
            raise RuntimeError(f"{self.compiler} not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [exe, *self.flags, "-o", str(tmp), *[str(s) for s in self.sources()]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(self.compiler).name} failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        return out

    def log(self) -> str:
        """The compiler's stderr from the build of the current sources ('' if none)."""
        log = self.path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on first call)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                if self.declare is not None:
                    self.declare(lib)
                self._lib = lib
            return self._lib


KERNELS = NativeLibrary("librtvm_kernels", PKG / "csrc", "*.cu", _nvcc(), NVCC_FLAGS)
build, build_log, library = KERNELS.build, KERNELS.log, KERNELS.load


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device. The same
    as ``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object (about 10 us a call on the card's host)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong, "f": ctypes.c_float}


class Entry:
    """A CUDA entry point of the kernel library. `name` counts its launches,
    `symbol` is its C name, `args` its argument types before the stream
    that every entry takes last, one letter each (p pointer, i int,
    q 64-bit int, f float), and `errors` the messages of its own non-zero codes."""

    def __init__(self, name: str, symbol: str, args: str, errors=None):
        self.name, self.symbol, self.errors = name, symbol, dict(errors or {})
        self.argtypes = [_CTYPES[a] for a in args] + [ctypes.c_void_p]
        self._fn = None

    def __call__(self, device, *args) -> None:
        """Launch on `device`'s current stream."""
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        code = self._fn(*args, stream_handle(device))
        if code:
            raise RuntimeError(f"{self.symbol}: "
                               + self.errors.get(code, f"CUDA error {code} at launch"))
        launches[self.name] += 1


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
