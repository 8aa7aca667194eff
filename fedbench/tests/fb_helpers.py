"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds."""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the -smoke cut of the program's configurations (every width small, the
# structure kept), and a traffic mix of the same shape that runs on the CPU
SMOKE = dict(n_layers=2, d_model=128, d_ff=256, vocab=512, n_heads=4,
             n_kv_heads=2, head_dim=32)
SMOKE_TRAFFIC = dict(clients=3, local_iters=2, directions=3, rows=2,
                     seq=16)
CELLS = ("qwen2-0.5b.aircomp.walk-heavy", "qwen2-0.5b.mean.forward-heavy")


def smoke_cell(name):
    """Cell ``name`` of BENCHMARK.json with its configuration and traffic
    cut to the smoke size; its limits as the chip's runs set them."""
    from fedbench import cell as fcell
    c = fcell.load(name)
    c.cfg = dict(c.cfg, **SMOKE)
    c.traffic = dict(c.traffic, **SMOKE_TRAFFIC)
    return c
