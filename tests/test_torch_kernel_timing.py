"""The kernel-timing harness and the benchmark snapshots of the port
(``repro_torch.obs.kernel_timing``, ``repro_torch.obs.bench``) against the
reference's.

On the CPU ``kernel_report`` times the kernels' plain versions: its rows
carry the reference's names, pass counts and byte model, projected at the
card's memory rate (``utils/hw.py``) instead of the reference's 819 GB/s
(at 819 GB/s the projections are the reference's). ``save_bench`` and
``load_benches`` round-trip under a temporary directory, the history kept
to ``HISTORY_KEEP``, with the port's provenance block.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.obs import bench as jbench
from repro.obs import kernel_timing as jkt
from repro_torch.obs import bench, kernel_timing as kt
from repro_torch.utils import hw

SIZES = [dict(n=4096, b2=4, m=3), dict(n=1000, b2=8, m=2)]


@pytest.mark.parametrize("size", SIZES, ids=["n4096", "n1000"])
def test_kernel_report_names_and_model_are_the_references(size):
    """Names, pass counts, modelled bytes and meta equal the reference's
    report at the same size; the projection is bytes over the card's
    3.35 TB/s (and the reference's at its 819 GB/s); the measured times
    are finite and positive."""
    want = jkt.kernel_report(**size)
    got = kt.kernel_report(device="cpu", **size)
    assert [k.name for k in got] == [k.name for k in want]
    for g, w in zip(got, want):
        assert (g.hbm_passes, g.hbm_bytes, g.meta) == (w.hbm_passes,
                                                       w.hbm_bytes, w.meta)
        assert g.model_us == pytest.approx(g.hbm_bytes / 3.35e12 * 1e6)
        assert np.isfinite(g.measured_us) and g.measured_us > 0
        assert [r[0] for r in g.rows()] == [r[0] for r in w.rows()]
        assert g.rows()[0][2] == w.rows()[0][2]
        assert g.rows()[1][2] == w.rows()[1][2]
    at_ref = kt.kernel_report(device="cpu", gbps=jkt.HBM_GBPS, **size)
    for g, w in zip(at_ref, want):
        assert g.model_us == pytest.approx(w.model_us)


def test_time_fn_and_card_constants():
    """``time_fn`` on CPU tensors takes the host clock; the datasheet
    constants are the H100 SXM5's."""
    x = torch.ones(1000)
    us = kt.time_fn(lambda a: a * 2.0, x, iters=3)
    assert np.isfinite(us) and us > 0
    assert kt.HBM_GBPS == pytest.approx(3350.0)
    assert (hw.HBM_BYTES_PER_S, hw.FP32_FLOP_PER_S, hw.BF16_FLOP_PER_S,
            hw.HBM_CAPACITY_BYTES) == (3.35e12, 67e12, 989e12, 80 * 2**30)


def test_save_and_load_bench_roundtrip(tmp_path):
    """Rows of either form normalize as the reference's; re-saving pushes
    the previous snapshot onto ``history`` (newest last, at most
    ``HISTORY_KEEP``); a corrupt file never blocks a save;
    ``load_benches`` finds every suite of the directory."""
    d = str(tmp_path)
    rows = [("zo_walk_us", 12.5, 2.0),
            {"name": "zo_replay_us", "us_per_call": 3, "derived": 7}]
    assert bench._rows_json(rows) == jbench._rows_json(rows)
    path = bench.save_bench("kernels", rows, config={"n": 4096}, out_dir=d)
    assert path == bench.bench_path("kernels", d)
    assert os.path.dirname(path) == d
    with open(path) as f:
        snap = json.load(f)
    assert snap["suite"] == "kernels" and snap["history"] == []
    assert snap["rows"] == jbench._rows_json(rows)
    assert snap["torch_version"] == torch.__version__
    assert "jax_version" not in snap
    assert {"cuda_version", "device", "power_limit", "git_sha",
            "timestamp"} <= set(snap)
    for i in range(bench.HISTORY_KEEP + 3):
        bench.save_bench("kernels", [("zo_walk_us", float(i), 2.0)],
                         out_dir=d)
    with open(path) as f:
        snap = json.load(f)
    assert len(snap["history"]) == bench.HISTORY_KEEP
    assert snap["history"][-1]["rows"][0]["us_per_call"] == float(
        bench.HISTORY_KEEP + 1)
    assert snap["rows"][0]["us_per_call"] == float(bench.HISTORY_KEEP + 2)
    with open(bench.bench_path("broken", d), "w") as f:
        f.write("{not json")
    bench.save_bench("broken", rows, out_dir=d)
    bench.save_bench("rounds", rows, out_dir=d)
    assert sorted(bench.load_benches(d)) == ["broken", "kernels", "rounds"]
    assert bench.HISTORY_KEEP == jbench.HISTORY_KEEP
