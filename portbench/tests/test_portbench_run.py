"""run.py refuses to run without a card and never falls back to the CPU;
nor does it run from a directory that holds only the benchmark."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from conftest import ROOT

ARGS = ["--workload", "resnet34-resident", "--seed", str(2**31 + 5), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_an_unknown_argument_is_refused():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "x"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
