"""The harness finds each piece by name, and imports nothing of the JAX side."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from h100bench import spec

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_side_imports(path):
    found = _imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"
    if path.parent.name == "reference":
        assert _imports(path) <= {"torch", "math", "typing", "__future__"}, "the reference imports torch alone"


def test_every_cell_loads():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.limits["limits"]["wrong_lengths"] == 0
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "output_tok_s"}
        for m in cell.per_layer:
            spec.reader("metrics", m["name"])
        for m in cell.end_to_end:
            spec.reader("e2e", m["name"])


def test_a_dropped_file_is_found_by_name(tmp_path):
    base = tmp_path / "h100bench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (base / "configs" / "tiny-model.json").write_text(
        json.dumps(dict(json.loads((base / "configs" / "h2o-danube-3-4b.json").read_text()), name="tiny-model")))
    (base / "traffic" / "bursty.json").write_text(
        json.dumps(dict(json.loads((base / "traffic" / "docqa-open.json").read_text()), rate=9.0)))
    (base / "limits" / "tiny-bursty.json").write_text(json.dumps({"sample_tokens": 1, "max_requests": 1,
                                                                   "limits": {"gap_max": 0.5, "wrong_lengths": 0}}))
    (base / "metrics" / "steps_counted.py").write_text("def read(obs):\n    return len(obs.steps)\n")
    bench["workloads"].append({"name": "tiny-bursty", "config": "tiny-model", "traffic": "bursty", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_counted", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "engine", "moves": "output_tok_s",
                               "workloads": ["tiny-bursty"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny-bursty", tmp_path / "BENCHMARK.json", base)
    assert cell.config["name"] == "tiny-model" and cell.traffic["rate"] == 9.0
    assert [m["name"] for m in cell.per_layer if m["name"] == "steps_counted"] == ["steps_counted"]

    class Obs:
        steps = [1, 2, 3]

    assert spec.reader("metrics", "steps_counted", base)(Obs()) == 3
