"""`run.py` without a card, and without the program."""
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("cell", ["parking.fleet32k", "quadrotor.fleet8k", "parking.mpc32k"])
def test_without_a_card_it_fails_and_prints_no_result(no_card, cell):
    out = _run(spec.ROOT, "--workload", cell, "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_without_the_program_it_fails(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, "--workload", "parking.fleet32k", "--seed", "3", "--seconds", "1", "--trace", "1")
    assert out.returncode != 0 and "{" not in out.stdout
