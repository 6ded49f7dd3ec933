"""The port's one way to build, load and launch native code
(``rtvm_tpu_torch/kernels.py``): the shared build routine on a C++ source
built with g++, and the launch helper over a stub library (no card here)."""

import pytest
import torch

from rtvm_tpu_torch import kernels


def test_the_build_routine_names_the_library_by_its_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "src"
    src.mkdir()
    (src / "two.cpp").write_text('extern "C" int rtvm_two(int x) {\n  return 2 * x; }\n')
    lib = kernels.NativeLibrary("librtvm_probe", src, "*.cpp", "g++",
                                ("-O2", "-shared", "-fPIC"))
    path = lib.build()
    stem, digest = path.stem.rsplit("_", 1)
    assert path.parent == tmp_path / "_build" and stem == "librtvm_probe"
    assert len(digest) == 16 and int(digest, 16) >= 0
    assert path.exists() and path.with_suffix(".log").exists()
    assert lib.build() == path == lib.path()
    assert lib.load().rtvm_two(21) == 42
    (src / "two.cpp").write_text('extern "C" int rtvm_two(int x) {\n  return 3 * x; }\n')
    changed = lib.build()
    assert changed != path and changed.exists() and path.exists()
    assert not list((tmp_path / "_build").glob("*.tmp.so"))  # written through os.replace


class _StubLibrary:
    """A kernel library whose one entry returns the codes it is given."""

    def __init__(self):
        self.calls = []

        def rtvm_stub(*args):  # a plain function, as ctypes' are: it takes argtypes
            self.calls.append(args)
            return args[0]

        self.rtvm_stub = rtvm_stub


def test_the_launch_helper_appends_the_stream_checks_and_counts(monkeypatch):
    stub = _StubLibrary()
    monkeypatch.setattr(kernels, "library", lambda: stub)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: 1000 + (device.index or 0))
    kernels.reset_launches()
    entry = kernels.Entry("stub", "rtvm_stub", "ipf", {-1: "the stub's own fault"})
    dev = torch.device("cuda", 3)  # never touched: the stream comes from the stub
    entry(dev, 0, 7, 0.5)
    entry(dev, 0, 8, 0.25)
    assert stub.calls == [(0, 7, 0.5, 1003), (0, 8, 0.25, 1003)]
    assert kernels.launches["stub"] == 2
    with pytest.raises(RuntimeError, match=r"^rtvm_stub: the stub's own fault$"):
        entry(dev, -1, 0, 0.0)
    with pytest.raises(RuntimeError, match=r"^rtvm_stub: CUDA error 700 at launch$"):
        entry(dev, 700, 0, 0.0)
    assert kernels.launches["stub"] == 2  # a launch that fails is not counted
    assert entry.argtypes[-1] is kernels.ctypes.c_void_p and len(entry.argtypes) == 4
    kernels.reset_launches()
    assert kernels.launches["stub"] == 0 and not kernels.launches
