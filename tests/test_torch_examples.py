"""Each ``examples_torch/`` script (the port's counterpart of each of the
reference's eleven examples; the serving one on the hybrid family) runs at
``--smoke --device cpu``: exit 0 and its closing line. One intra-op thread each: the workers share
the cores."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "quickstart.py": ([], "final test accuracy"),
    "aircomp_demo.py": ([], "channel-truncated AirComp"),
    "blackbox_attack.py": (["--out", "{tmp}/curve.csv"], "SNR sweep: 6"),
    "wireless_scenario.py": ([], "bitwise tiered == resident"),
    "tiered_scale.py": ([], "bitwise tiered == resident at N=50000"),
    "resumable_run.py": (["--dir", "{tmp}/ck"],
                         "resumed run is bitwise the uninterrupted"),
    "serve_lm.py": (["--arch", "hymba-1.5b-smoke"], "serve OK"),
    "softmax_regression.py": ([], "FedZO  H=5 AirComp 0dB: test acc"),
    "seed_compression.py": ([], "round 1: loss"),
    "train_cnn.py": ([], "final test accuracy"),
    "train_lm.py": ([], "done: loss"),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_example_smoke_on_cpu(script, tmp_path):
    extra, want = SCRIPTS[script]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, os.path.join(REPO, "examples_torch", script),
           "--smoke", "--device", "cpu",
           *(a.format(tmp=tmp_path) for a in extra)]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert want in out.stdout, out.stdout[-3000:]
