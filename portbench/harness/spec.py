"""Where the benchmark's parts live, found by name.

  BENCHMARK.json              the cells, the metrics and which cells each
                              metric is read in
  configs/<config>.json       a configuration's sizes as run, and under
                              ``reference`` the name of its plain model
  reference/<reference>.py    a plain model: its leaves, loss and FLOPs
                              (the contract heads ``reference/model.py``)
  workloads/<cell>.json       a cell's traffic: codec, transport, xi cycle,
                              step sizes and the limits of ``correct``
  metrics/<metric>.py         one reader a metric: ``read(run)`` returns
                              the number, or None where it finds nothing

A new cell, configuration, plain model or metric is a new file here and
an entry in ``BENCHMARK.json``; no code names one.  Each lookup takes a
``directory`` in place of its own (the tests').
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent


def benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config(name: str, directory: Path = None) -> dict:
    return json.loads(((directory or HERE / "configs") / f"{name}.json")
                      .read_text())


def workload(name: str, directory: Path = None) -> dict:
    """A cell's traffic file; ``p`` is its xi cycle's share of ones."""
    path = (directory or HERE / "workloads") / f"{name}.json"
    cell = json.loads(path.read_text())
    cycle = cell["xi_cycle"]
    if not cycle or set(cycle) - {0, 1} or 0 not in cycle or 1 not in cycle:
        raise ValueError(f"{name}: an xi cycle is 0s and 1s with both in it")
    cell["p"] = sum(cycle) / len(cycle)
    cell["name"] = name
    return cell


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _load(f"portbench_metric_{metric}",
                 HERE / "metrics" / f"{metric}.py").read


def reference(cfg: dict, directory: Path = None):
    """The plain model ``reference/<cfg["reference"]>.py`` of a
    configuration, as a module."""
    if "reference" not in cfg:
        raise KeyError(f"{cfg.get('name', 'a configuration')} names no "
                       "reference model")
    name = cfg["reference"]
    return _load(f"portbench_reference_{name}",
                 (directory or HERE / "reference") / f"{name}.py")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    every metric without a ``workloads`` key, and those that list it."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_entry(bench: dict, cell: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == cell:
            return entry
    raise KeyError(f"BENCHMARK.json has no cell {cell!r}")
