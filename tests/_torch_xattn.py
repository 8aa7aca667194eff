"""Checks shared by the enc-dec and VLM tests (``test_torch_encdec.py``,
``test_torch_vlm.py``): the port's cross-attention families against a live
JAX run of the reference at ``-smoke`` size.

Both packages start from the same weights (``utils/convert.to_torch`` of
the reference's init) and batches; inputs come from numpy seeds, in
float32. A VLM's gates are set to 0.5 in both trees (``gated``): at the
reference's zero gates ``tanh(0) = 0`` hides the whole cross path, and a
broken one would pass. Each tolerance stands beside its reason in the
test that uses it.
"""
import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import repro  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import fedzo
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.utils import convert, prng
from repro_torch.utils.tree import tree_map

B, S = 2, 16
GATE = 0.5


def jpaths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(k.key for k in path), leaf) for path, leaf in leaves]


def close(got, want, rel=1e-5):
    """Within ``rel`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def gated(tree):
    """The tree with every ``gate_*`` leaf set to GATE (a VLM's; no-op for
    another tree)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: np.full_like(v, GATE)
        if p[-1].key.startswith("gate_") else v, tree)


def models(arch):
    """(reference model, port model, reference params (gated), port
    params: the same weights)."""
    jm, tm = japi.build(jget_config(arch)), api.build(get_config(arch))
    jp = gated(jax.device_get(jm.init(jax.random.key(0))))
    return jm, tm, jp, convert.to_torch(jp)


def count_kernel_calls(monkeypatch):
    """Count the calls of ``ops.rmsnorm`` and ``ops.attention`` (on the
    CPU they run the plain versions; on the card each is one launch)."""
    calls = {"rmsnorm": 0, "attention": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    return calls


def kernel_calls(cfg, kind):
    """RMSNorm and attention calls of one ``kind`` ("prefill" or "decode")
    forward: ``chip_smoke.xattn_launches``, the launch counts the card's
    run holds the served models to."""
    want = chip_smoke.xattn_launches(cfg, kind)
    return {"rmsnorm": want["rmsnorm"],
            "attention": want["flash_attention"]}


def cli_lines(jmain, tmain, argv, monkeypatch):
    """(reference CLI's lines, port CLI's lines, port result) of one run
    each with ``argv`` (the port's on the CPU)."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    with contextlib.redirect_stdout(buf):
        jmain()
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tmain(argv + ["--device", "cpu"])
    return want, buf.getvalue().splitlines(), res


def train_clis(jmain, tmain, argv, tmp_path, monkeypatch):
    """The training CLIs with ``argv``, the reference's writing under
    ``tmp_path / "j"``, the port's (on the CPU) under ``tmp_path / "t"``:
    (reference lines, port lines, port result)."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--out", str(tmp_path / "j")])
    with contextlib.redirect_stdout(buf):
        jmain()
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tmain(argv + ["--device", "cpu", "--out", str(tmp_path / "t")])
    return want, buf.getvalue().splitlines(), res


def same_bits(t, j):
    """A tensor and an array hold the same bits (bfloat16 included)."""
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
    return np.array_equal(t.numpy(), j)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def no_vmap(monkeypatch):
    """Make ``torch.func.vmap`` raise: the cohort paths never reach it."""
    def refuse(*a, **k):
        raise AssertionError("reached torch.func.vmap")
    monkeypatch.setattr(torch.func, "vmap", refuse)


def cohort_loss_runs(tm, tp, monkeypatch):
    """Two clients (the weights ``tp`` and a copy scaled by 0.99) on two
    batches: ``tm.loss_batched`` equals each client's ``tm.loss`` within
    rtol 2e-7, and ``fedzo.batched_loss`` takes it without reaching
    ``torch.func.vmap``."""
    no_vmap(monkeypatch)
    rows = [tp, tree_map(lambda x: x * 0.99, tp)]
    cohort = tree_map(lambda a, b: torch.stack([a, b]), *rows)
    shape = ShapeConfig("t", 4, 1, "train")
    bs = [api.make_batch(tm, shape, prng.key(i), device="cpu")
          for i in (0, 1)]
    batch = {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
    assert fedzo.batched_loss(tm.loss) is tm.loss_batched
    got = fedzo.batched_loss(tm.loss)(cohort, batch)
    each = torch.stack([tm.loss(p, b) for p, b in zip(rows, bs)])
    torch.testing.assert_close(got, each, rtol=2e-7, atol=0)
