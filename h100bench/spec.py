"""Finds a cell's pieces by name: ``BENCHMARK.json`` at the repository root
names the cell's configuration, traffic mix and metrics; each is a file of
its own under this directory.

* configuration ``<config>``: ``configs/<config>.json`` (its ``model``
  holds the program's ``ModelConfig`` fields, ``engine`` the engine's
  slots and pages, ``reference`` the module under ``reference/`` that
  computes it plainly);
* traffic ``<traffic>``: ``traffic/<traffic>.json`` (read by
  :mod:`h100bench.traffic`);
* metric ``<name>``: ``e2e/<name>.py`` for an end-to-end metric,
  ``metrics/<name>.py`` for a per-layer one, each with ``read(obs)``;
* the comparison that decides ``correct``: ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json", base: Path = HERE) -> Cell:
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; known: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    read = lambda sub, n: json.loads((base / sub / f"{n}.json").read_text())  # noqa: E731
    return Cell(name, w["chips"], read("configs", w["config"]), read("traffic", w["traffic"]),
                read("limits", name), e2e, per_layer)


def _load(path: Path):
    """The module in ``path`` (a name may hold dots, so not imported by name)."""
    spec = importlib.util.spec_from_file_location("h100bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, base: Path = HERE):
    """The ``read(obs)`` of metric ``name`` (``kind``: ``"e2e"`` or ``"metrics"``)."""
    return _load(base / kind / f"{name}.py").read


def reference_module(config: dict, base: Path = HERE):
    """The plain reference that ``config`` names (``reference/<name>.py``)."""
    return _load(base / "reference" / f"{config['reference']}.py")


def read_all(kind: str, metrics: List[dict], obs, base: Path = HERE) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds something to read."""
    out = {}
    for m in metrics:
        value = reader(kind, m["name"], base)(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
