"""``run.py`` as a check of the benchmark starts it: no result without a card, nor in a
checkout that holds only the benchmark; on a card, a short run is correct."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd: Path, *extra):
    cmd = [sys.executable, "h100bench/run.py", "--workload", "danube-docqa", "--seed", str(2**31 + 5),
           "--seconds", "10", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=1200)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"output_tok_s", "ttft_p90_ms", "setup_s"}
