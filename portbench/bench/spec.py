"""Everything a cell is made of, found by the names in ``BENCHMARK.json``.

A cell names a configuration (its file is given in ``configs``) and a
traffic mix (``traffic/<name>.json``); each metric is a reader,
``metrics/<name>.py``, with a function ``read(run) -> float | None``. A
later change adds a configuration, a mix or a metric by adding a file and
an entry, and edits none."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(run) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    end_to_end: list[Metric]
    per_layer: list[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(ROOT / cfg["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[Metric(m["name"], m["unit"], reader(m["name"]))
                    for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[Metric(m["name"], m["unit"], reader(m["name"]))
                   for m in bench["per_layer"] if _applies(m, name)],
    )
