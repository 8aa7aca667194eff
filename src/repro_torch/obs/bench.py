"""Persisted per-suite benchmark snapshots.

Counterpart of ``repro/obs/bench.py:1-103``. A benchmark suite writes
``results/BENCH_<suite>.json`` through ``save_bench``: the current rows and
a provenance block (torch and CUDA versions, the card and its power limit,
the git sha, a UTC timestamp, an optional config note). Saving a suite
again pushes the previous snapshot onto the file's ``history`` list, kept
to the newest ``HISTORY_KEEP``, so the trajectory accumulates in place.
"""
from __future__ import annotations

import datetime
import glob
import json
import os
import subprocess
from typing import Optional

import torch

HISTORY_KEEP = 20
_PROVENANCE = ("timestamp", "torch_version", "cuda_version", "device",
               "power_limit", "git_sha", "rows")


def results_dir(path: Optional[str] = None) -> str:
    """The snapshot directory: ``path`` when given, else the repo's
    ``results/``."""
    if path:
        return path
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    cand = os.path.join(repo, "results")
    return cand if os.path.isdir(cand) else "results"


def bench_path(suite: str, out_dir: Optional[str] = None) -> str:
    return os.path.join(results_dir(out_dir), f"BENCH_{suite}.json")


def _rows_json(rows) -> list:
    """Harness rows ((name, us, derived) tuples or dicts) as JSON rows."""
    out = []
    for r in rows:
        if isinstance(r, dict):
            out.append({"name": r["name"],
                        "us_per_call": float(r.get("us_per_call", 0.0)),
                        "derived": r.get("derived")})
        else:
            name, us, derived = r
            out.append({"name": name, "us_per_call": float(us),
                        "derived": derived})
    return out


def _card() -> tuple:
    """(name, power limit) of card 0 as ``nvidia-smi`` reports them, or
    (None, None) without a card."""
    if not torch.cuda.is_available():
        return None, None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), limit.strip()
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(0), None


def save_bench(suite: str, rows, *, config=None,
               out_dir: Optional[str] = None) -> str:
    """Snapshot one suite's rows to ``BENCH_<suite>.json``; the previous
    snapshot moves onto the file's ``history`` (newest last, at most
    ``HISTORY_KEEP``). Returns the path written."""
    from repro_torch.obs.manifest import git_sha

    path = bench_path(suite, out_dir)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    history = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            history = list(prev.get("history", []))
            history.append({k: prev.get(k) for k in _PROVENANCE})
            history = history[-HISTORY_KEEP:]
        except (OSError, ValueError, KeyError):
            history = []  # a corrupt snapshot never blocks a new one
    device, power_limit = _card()
    snap = {"suite": suite,
            "rows": _rows_json(rows),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": device,
            "power_limit": power_limit,
            "git_sha": git_sha(),
            "timestamp": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "config": config,
            "history": history}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=2, default=str)
    os.replace(tmp, path)
    return path


def load_benches(out_dir: Optional[str] = None) -> dict:
    """Every ``BENCH_*.json`` snapshot of a results directory, by suite."""
    out = {}
    for p in sorted(glob.glob(os.path.join(results_dir(out_dir),
                                           "BENCH_*.json"))):
        try:
            with open(p) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        suite = snap.get("suite") or \
            os.path.basename(p)[len("BENCH_"):-len(".json")]
        out[suite] = snap
    return out
