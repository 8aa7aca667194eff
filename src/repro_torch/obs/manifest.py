"""Run manifests: one JSON document that says what ran.

Counterpart of ``repro/obs/manifest.py``, with the same keys: the config
and its hash (``checkpoint.config_hash``, as the snapshot sidecars record
it, so a manifest and a checkpoint of one run cross-check), the strategy,
the versions, the git sha of the tree, the device topology, the comms
ledger, the fault and wireless-scenario blocks and the run's event stream
(divergence rollbacks). The versions block names torch and CUDA where the
reference names jax; ``topology`` reads ``torch.cuda``.

``sim.run_experiment`` writes one beside durable checkpoints
(``<checkpoint_dir>/manifest.json``) and beside a file-backed metric sink
(``<sink>.manifest.json``).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import platform
import subprocess
from typing import Optional

import torch

MANIFEST_NAME = "manifest.json"


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Best-effort git sha of the source tree (None outside a checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def device_topology() -> dict:
    """The visible devices: the CUDA cards, else the CPU."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        devs = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                for i in range(n)]
        plat = "gpu"
    else:
        n, devs, plat = 1, ["cpu"], "cpu"
    return {"platform": plat, "device_count": n, "local_device_count": n,
            "process_count": 1, "devices": devs}


def build_manifest(cfg=None, *, strategy: Optional[str] = None,
                   rounds: Optional[int] = None,
                   n_clients: Optional[int] = None, ledger=None,
                   faults=None, channel=None, events=None,
                   extra: Optional[dict] = None) -> dict:
    """Assemble a run manifest dict; every part is optional (the
    reference's ``mesh`` block belongs to the sharded round, which is not
    ported)."""
    from repro_torch.checkpoint.checkpoint import config_hash

    md = {"created_at": datetime.datetime.now(
              datetime.timezone.utc).isoformat(),
          "torch_version": torch.__version__,
          "cuda_version": torch.version.cuda,
          "python_version": platform.python_version(),
          "git_sha": git_sha(),
          "topology": device_topology()}
    if cfg is not None:
        md["config_hash"] = config_hash(cfg)
        md["config"] = (dataclasses.asdict(cfg)
                        if dataclasses.is_dataclass(cfg) else dict(cfg))
    if strategy is not None:
        md["strategy"] = strategy
    if rounds is not None:
        md["rounds"] = int(rounds)
    if n_clients is not None:
        md["n_clients"] = int(n_clients)
    if ledger is not None:
        md["comms"] = ledger.manifest()
    if faults is not None:
        md["faults"] = faults.describe()
    if channel is not None:
        md["channel"] = channel.describe()
    md["events"] = [dict(e) for e in (events or [])]
    if extra:
        md.update(extra)
    return md


def write_manifest(path: str, manifest: dict) -> str:
    """Write a manifest as JSON. ``path`` is a directory (the manifest
    lands as ``manifest.json`` in it) or a file path. Returns the file
    written."""
    if os.path.isdir(path) or path.endswith(os.sep):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, MANIFEST_NAME)
    else:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


def read_manifest(path: str) -> dict:
    """Read a manifest written by ``write_manifest`` (file or dir path)."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    with open(path) as f:
        return json.load(f)
