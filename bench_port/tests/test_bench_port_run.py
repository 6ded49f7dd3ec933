"""run.py without a CUDA card, and in a tree that holds only BENCHMARK.json
and bench_port/: it exits non-zero and prints no result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "sift360-yolov8n.live", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


def run_in(root):
    return subprocess.run([sys.executable, "bench_port/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = run_in(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_in(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
