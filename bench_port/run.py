#!/usr/bin/env python3
"""The benchmark of rtvm_tpu_torch: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The cell is
an entry of ``workloads`` in ``BENCHMARK.json``; its configuration, traffic
mix and limits are files under ``bench_port/`` found by name (README.md).
Set-up makes the orbit's frames from the seed, loads the configuration's
YOLO checkpoint (bundled, or drawn from the seed and written under TMPDIR)
and runs the mix's entry once on the cell's shapes; the window
then runs the entry for ``--seconds`` on the host clock, ending after
``torch.cuda.synchronize()``. With ``--trace 1`` the same run carries
``torch.profiler`` over a few steps and reports the per-layer metrics
instead of the end-to-end ones. After the window the outputs are held to
the plain references (``lib/check.py``); the numbers compared, each with
its limit, are the last lines on standard error and the last key of the
result, which is the last line of standard output.

Without a CUDA card, or with fewer than the cell asks for, it exits with 2
and prints no result; so it does when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rtvm_tpu")


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds (the port's own kernels build
    into rtvm_tpu_torch/_build/, also inside it)."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def load_cell(name: str) -> dict:
    """The cell's entry of BENCHMARK.json with its files: the cell
    (limits), the configuration and the traffic mix."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cell = json.loads((HERE / "cells" / f"{name}.json").read_text())
    if (cell["config"], cell["traffic"]) != (wl["config"], wl["traffic"]):
        raise SystemExit(f"run.py: cells/{name}.json names {cell['config']}/{cell['traffic']}, "
                         f"BENCHMARK.json {wl['config']}/{wl['traffic']}")
    return {"bench": bench, "workload": wl, "cell": cell,
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "mix": json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())}


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The cell's metrics of one kind: those without a ``workloads`` key and
    those that list the cell."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx: dict):
    """The read(ctx) of bench_port/metrics/<name>.py, or of the file of the
    name's part before its first dot (``window_launches.live`` is
    ``window_launches`` in the live cell): a number, or None when it finds
    nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def card_power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    spec = load_cell(args.workload)

    import torch

    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bench_port.lib.harness import run_cell

    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                   read_metric, metrics_of)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 2
    res["device"]["power"] = card_power_limit()
    info = res.pop("info")
    res["checks"] = res.pop("checks")  # the compared numbers come last
    print(f"check info: {json.dumps(info)}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
