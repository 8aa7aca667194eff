"""A cell of ``BENCHMARK.json``, found by name, and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives:

- the configuration ``configs/<config>.json`` (the entry's ``file``), with
  its family's parameter layout, FLOP counts and plain reference in
  ``models/<family>.py``;
- the traffic mix ``traffic/<traffic>.json``;
- each per-layer metric's reader ``metrics/<metric>.py`` (``read(window)``);
- the cell's correctness limits ``limits/<workload>.json``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    family: object
    end_to_end: list          # metric entries of BENCHMARK.json
    per_layer: list
    limits: dict


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def family_module(name: str):
    return importlib.import_module(f"fedbench.models.{name}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"fedbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench_path=None) -> Cell:
    bench = _load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = _load_json(os.path.join(ROOT, conf["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      f"{entry['traffic']}.json"))
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    limits = _load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(
        name=workload, chips=entry["chips"], cfg=cfg, traffic=traffic,
        family=family_module(cfg["family"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=limits.get("limits", {}))
