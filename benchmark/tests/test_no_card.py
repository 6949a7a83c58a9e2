"""The measured command prints no result and exits non-zero where no card
is visible, and in a directory that holds only the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run

ARGS = ["-m", "benchmark.run", "--workload", "kitti360.stream", "--seed",
        "3000000017", "--seconds", "1", "--trace", "0"]


def call(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def assert_no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
        assert "metrics" not in parsed


def test_no_card_no_result():
    assert_no_result(call(run.ROOT))


def test_benchmark_files_alone(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert_no_result(call(tmp_path))
