"""BENCHMARK.json and the files it names: present, loadable, and within
the names, units and limits the benchmark's contract allows."""
import json
import os
import re

import pytest

from fb_helpers import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["fedbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for word in b["command"]:
        assert LINE.match(word) and not word.startswith("/") \
            and ".." not in word
    assert os.path.isfile(os.path.join(ROOT, b["command"][1]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    entries = bench()[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads"):
                assert LINE.match(e[key]), e[key]


def test_configs_load():
    from fedbench import cell as fcell
    for c in bench()["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("fedbench/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        fam = fcell.family_module(cfg["family"])
        assert sum(1 for _ in fam.param_shapes(cfg)) > 0
        assert cfg["assumed"]


@pytest.mark.parametrize("name", CELLS)
def test_cells_load(name):
    from fedbench import cell as fcell
    c = fcell.load(name)
    assert c.chips == 1
    for key in ("clients", "local_iters", "directions", "rows", "seq", "mu",
                "lr", "aggregation"):
        assert key in c.traffic, key
    assert {m["name"] for m in c.end_to_end} == {"round_ms", "peak_gib",
                                                 "setup_s"}
    for m in c.per_layer:
        assert callable(fcell.reader(m["name"]))
        assert m["moves"] == "round_ms"
    from fedbench import check
    assert set(c.limits) == set(check.NUMBERS)


def test_metric_entries():
    b = bench()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


def test_run_without_a_card_prints_no_result(tmp_path):
    """On a machine without a card (this one) the run exits 2 and prints
    no result; so does a copy holding only BENCHMARK.json and fedbench/."""
    import shutil
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "fedbench"), tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, str(tmp_path)):
        res = subprocess.run(
            [sys.executable, "fedbench/run.py", "--workload", CELLS[0],
             "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
            cwd=where, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=""))
        assert res.returncode == 2, res.stderr[-2000:]
        assert res.stdout.strip() == ""
