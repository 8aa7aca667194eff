"""Nothing the harness loads is JAX, the JAX package or its benchmarks
(top-level module names compared whole: ``repro_torch`` is not
``repro``), and the reference loads nothing of the port."""
import os
import subprocess
import sys

from fb_helpers import ROOT

CODE = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from fb_helpers import smoke_cell
from fedbench import check, harness, readings
c = smoke_cell("qwen2-0.5b.aircomp.walk-heavy")
out = harness.run(c, 5, 0.0, 1, device="cpu")
check.readings(c, 5, out, "cpu")
top = {{name.split(".")[0] for name in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "repro", "benchmarks"}}))
print("repro_torch" in top)
"""

REF = r"""
import sys
sys.path[:0] = [{root!r}]
import fedbench.reference.fedzo, fedbench.models.dense
print(sorted({{n.split(".")[0] for n in sys.modules}} & {{"repro_torch",
      "repro", "jax"}}))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.split("\n")


def test_harness_loads_no_jax():
    tests = os.path.join(ROOT, "fedbench", "tests")
    out = _run(CODE.format(src=os.path.join(ROOT, "src"), root=ROOT,
                           tests=tests))
    assert out[-3] == "[]" and out[-2] == "True"


def test_reference_loads_nothing_of_the_port():
    assert _run(REF.format(root=ROOT))[-2] == "[]"
