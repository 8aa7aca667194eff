"""The expert-parallel ``moe_fwd`` of the port (``models/moe.py``) on a
(2, 2) ``("data", "model")`` mesh of 4 gloo ranks on the CPU, against the
reference's ``shard_map`` ``moe_fwd`` on a (2, 2) mesh of 4 host devices
(a subprocess: the device count is fixed before jax starts) and against
the one-device forward.

Cases: qwen3-moe-30b-a3b-smoke in the train layout (x [4, 16, d]: 64
tokens over the 2 data ranks) and the decode layout (x [3, 1, d]: 3
tokens, which do not divide, replicated), each at capacity factor 8 (E/k:
nothing is dropped) and 1.25 (the config's own; with its 4 experts and
balanced routing nothing is dropped either), and the train layout at 0.5,
where the shard's capacity drops tokens, the same ones in both packages.
The inputs are the reference's own arrays.

Tolerances: the reference's own for its sharded-vs-oracle test (atol 2e-4
on the output, rtol 1e-4 on the aux, ``tests/test_moe.py``); the port's
sharded forward against the reference's sharded one, case for case, at
the same atol; at factor 8 the port's sharded forward against its own
one-device forward at atol 2e-4, and the one-device forwards of the two
packages at atol 2e-5 (float32 GEMMs in another summation order)."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from tests import _torch_ranks
from tests.conftest import run_subprocess

CASES = [(f, lay) for f in (8.0, 1.25) for lay in ("train", "decode")] \
    + [(0.5, "train")]
SHAPES = {"train": (4, 16), "decode": (3, 1)}

_REF = """
import json, sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import _make_mesh
from repro.models.moe import init_moe, moe_fwd
out = sys.argv[1] if len(sys.argv) > 1 else OUT
mesh = _make_mesh((2, 2), ("data", "model"))
res = {}
for f, lay, (B, S) in CASES:
    cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(capacity_factor=f)
    p = init_moe(jax.random.key(0), cfg, jnp.float32)
    x = 0.5 * jax.random.normal(jax.random.key(1), (B, S, cfg.d_model), jnp.float32)
    ol, al = moe_fwd(p, cfg, x)
    os_, as_ = jax.jit(lambda p, x: moe_fwd(p, cfg, x, mesh=mesh))(p, x)
    tag = f"{f}_{lay}"
    for k, v in p.items():
        res[f"{tag}/p/{k}"] = np.asarray(v)
    res[f"{tag}/x"] = np.asarray(x)
    res[f"{tag}/out_local"] = np.asarray(ol)
    res[f"{tag}/aux_local"] = np.asarray(al)
    res[f"{tag}/out_sharded"] = np.asarray(os_)
    res[f"{tag}/aux_sharded"] = np.asarray(as_)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_moe")
    ref_path = str(d / "ref.npz")
    cases = [(f, lay, SHAPES[lay]) for f, lay in CASES]
    run_subprocess(f"CASES = {cases!r}\nOUT = {ref_path!r}\n" + _REF,
                   n_devices=4)
    ref = dict(np.load(ref_path))
    port_cases = []
    for f, lay in CASES:
        tag = f"{f}_{lay}"
        cfg = get_config("qwen3-moe-30b-a3b-smoke").replace(
            capacity_factor=f)
        p = {k.split("/")[-1]: torch.from_numpy(v) for k, v in ref.items()
             if k.startswith(f"{tag}/p/")}
        port_cases.append((cfg, p, torch.from_numpy(ref[f"{tag}/x"])))
    out = str(d / "port.pt")
    tmesh.run_ranks(_torch_ranks.moe_mesh_run, 4, backend="gloo",
                    init_dir=str(d), args=(out, port_cases))
    port = torch.load(out)
    return ref, port_cases, dict(zip(CASES, port))


@pytest.mark.parametrize("case", CASES, ids=[f"{f}-{lay}" for f, lay in CASES])
def test_sharded_moe_matches_reference_sharded(runs, case):
    ref, _, port = runs
    tag = f"{case[0]}_{case[1]}"
    got = port[case]
    np.testing.assert_allclose(got["out"].numpy(), ref[f"{tag}/out_sharded"],
                               atol=2e-4)
    np.testing.assert_allclose(float(got["aux"]),
                               float(ref[f"{tag}/aux_sharded"]), rtol=1e-4)
    # the layouts: tokens over data (train) or replicated (decode)
    want = "Shard(dim=0)" if case[1] == "train" else "Replicate()"
    assert got["placements"].startswith(f"({want}")


@pytest.mark.parametrize("layout", ["train", "decode"])
def test_sharded_moe_matches_one_device_at_capacity_e_over_k(runs, layout):
    """Capacity factor 8 = E/k for the smoke config: nothing is dropped on
    any shard, so the sharded and the one-device forwards agree."""
    ref, cases, port = runs
    i = CASES.index((8.0, layout))
    cfg, p, x = cases[i]
    assert cfg.capacity_factor * cfg.top_k >= cfg.n_experts
    out, aux = tmoe.moe_fwd(p, cfg, x)
    np.testing.assert_allclose(port[(8.0, layout)]["out"].numpy(),
                               out.numpy(), atol=2e-4)
    np.testing.assert_allclose(float(port[(8.0, layout)]["aux"]),
                               float(aux), rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref[f"8.0_{layout}/out_local"],
                               atol=2e-5)


def test_capacity_of_the_shard_drops_in_both_packages(runs):
    """At factor 0.5 the train layout's capacity counts the shard's 32
    tokens (9 slots an expert against 17 for all 64): tokens are dropped,
    both packages' sharded outputs leave the one-device one alike (the
    same drops), and the port stays within atol 2e-4 of the reference's."""
    ref, cases, port = runs
    cfg, p, x = cases[CASES.index((0.5, "train"))]
    assert tmoe._capacity(32, cfg, cfg.n_experts // 2) \
        < tmoe._capacity(64, cfg, cfg.n_experts)
    out, _ = tmoe.moe_fwd(p, cfg, x)
    sharded = port[(0.5, "train")]["out"].numpy()
    assert np.abs(sharded - out.numpy()).max() > 1e-3
    np.testing.assert_allclose(sharded, ref["0.5_train/out_sharded"],
                               atol=2e-4)


def test_one_member_mesh_is_the_one_device_forward():
    """``make_host_mesh()`` without a process group: one member, every
    expert local, plain tensors in and out, bitwise ``mesh=None``."""
    cfg = get_config("qwen3-moe-30b-a3b-smoke")
    from repro_torch.utils import prng
    p = tmoe.init_moe(prng.key(0), cfg, torch.float32)
    x = 0.5 * prng.normal(prng.key(1), (2, 8, cfg.d_model))
    a = tmoe.moe_fwd(p, cfg, x)
    b = tmoe.moe_fwd(p, cfg, x, mesh=make_host_mesh(device="cpu"))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
