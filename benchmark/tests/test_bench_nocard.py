"""Without a card the command fails and prints no result: no CPU
fallback. Decided inside the test: skipped where a card is present."""
import subprocess
import sys

import pytest
import torch

from benchmark.tests.runner import ROOT


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dtu49-grid8",
         "--seed", str(2**33 + 1), "--seconds", "10", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_a_folder_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ cannot run."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dtu49-grid8",
         "--seed", "3", "--seconds", "10", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
