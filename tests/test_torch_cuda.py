"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False (the check runs inside the fixture, never at import). On a machine
with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The sign kind and the AirComp mean are bitwise; the normal kind within 4
ulp of the summed terms; the norms within a relative 1e-5. RMSNorm and flash
attention: float32 within a relative 1e-5 (another summation order),
bfloat16 within 1 bf16 ulp of the output. ``chip_smoke.py`` repeats these at
the main path's full shapes and times them.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import zo_aircomp as zac
from repro_torch.kernels import zo_axpy as za
from repro_torch.utils import prng

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _keys(gen, m):
    return torch.randint(0, 2 ** 32, (m, 2), generator=gen, device="cuda",
                         dtype=torch.int64)


def _ulps(got, want, scale):
    spacing = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    return float(((got - want).abs() / spacing).max())


@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("n", [4096, 1000, 1])
def test_zo_walk_and_replay_on_card(gen, kind, n):
    x = torch.randn(3, n, generator=gen, device="cuda")
    keys = _keys(gen, 3)
    ab = torch.randn(3, 2, generator=gen, device="cuda")
    c = torch.randn(3, 5, generator=gen, device="cuda")
    walk = ops.zo_walk(x, keys, (1, 2), ab, kind=kind)
    replay = ops.zo_replay(x, keys, c, kind=kind)
    pwalk = za.zo_walk_plain(x, keys, (1, 2), ab, kind=kind)
    preplay = za.zo_replay_plain(x, keys, c, kind=kind)
    torch.cuda.synchronize()
    if kind == "sign":
        assert torch.equal(walk, pwalk) and torch.equal(replay, preplay)
    else:
        big = x.abs() + 20 * (ab.abs().sum(1, keepdim=True)
                              + c.abs().sum(1, keepdim=True))
        assert _ulps(walk, pwalk, big) <= 4
        assert _ulps(replay, preplay, big) <= 4


@pytest.mark.parametrize("kind", ["normal", "sign"])
@pytest.mark.parametrize("d", [1, 4096, 7850])
def test_zo_dirnorms_on_card(gen, kind, d):
    keys = _keys(gen, 4)
    got = ops.zo_dirnorms(keys, d, b2=7, kind=kind)
    want = za.zo_dirnorms_plain(keys, d, b2=7, kind=kind)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [65536, 1000])
def test_aircomp_reduce_on_card(gen, n):
    x = torch.randn(10, n, generator=gen, device="cuda") * 1e-3
    s = torch.rand(10, generator=gen, device="cuda")
    mean, sq = ops.aircomp_reduce(x, s, min(n, 7850))
    pmean, psq = zac.aircomp_reduce_plain(x, s, min(n, 7850))
    assert torch.equal(mean, pmean)
    torch.testing.assert_close(sq, psq, rtol=1e-5, atol=0)


def test_wrappers_count_their_launches(gen):
    ops.reset_launches()
    x = torch.zeros(2, 300, device="cuda")
    keys = _keys(gen, 2)
    ops.zo_walk(x, keys, (0, 1), torch.ones(2, 2, device="cuda"))
    ops.zo_replay(x, keys, torch.ones(2, 3, device="cuda"))
    ops.zo_dirnorms(keys, 300, b2=3)
    ops.aircomp_reduce(x, torch.ones(2, device="cuda"), 300)
    torch.cuda.synchronize()
    ops.rmsnorm(torch.ones(4, 64, device="cuda"),
                torch.ones(64, device="cuda"))
    q = torch.ones(1, 8, 2, 32, device="cuda")
    ops.attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"zo_walk": 1, "zo_replay": 1, "zo_dirnorms": 1,
                            "aircomp_reduce": 1, "rmsnorm": 1,
                            "flash_attention": 1}


def _bf16_ulps(got, want, floor):
    w = want.float().abs().clamp_min(floor)
    _, e = torch.frexp(w)
    spacing = torch.ldexp(torch.ones_like(w), e - 8)
    return float(((got.float() - want.float()).abs() / spacing).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(512, 896), (7, 64), (1, 100),
                                    (513, 32)])
def test_rmsnorm_on_card(gen, dtype, rows, d):
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    sc = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    got = ops.rmsnorm(x, sc)
    want = rn.rmsnorm_plain(x, sc)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert _bf16_ulps(got, want, 1e-30) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", [
    (4, 128, 14, 2, 64, True, 0),    # the Qwen2-0.5B train step
    (2, 100, 14, 2, 64, True, 0),    # ragged S, G = 7
    (2, 128, 4, 2, 32, True, 32),    # window, G = 2
    (1, 100, 4, 2, 32, False, 0),    # non-causal, ragged
    (1, 70, 2, 1, 128, True, 0),     # head dim 128
    (2, 16, 4, 2, 32, True, 0),      # the smoke model
])
def test_attention_on_card(gen, dtype, b, s, hq, hkv, hd, causal, window):
    q = torch.randn(b, s, hq, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    top = float(want.float().abs().max())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * top
    else:
        assert _bf16_ulps(got, want, 1e-5 * top) <= 1


def test_prng_draws_on_card_match_the_cpu(gen):
    """Integer draws bitwise; uniform bitwise (exact float ops); normal
    within a few ulp (log1p/sqrt of the card's math library)."""
    k = prng.key(5)
    np.testing.assert_array_equal(
        prng.random_bits(k, (3, 1000), device="cuda").cpu().numpy(),
        prng.random_bits(k, (3, 1000)).numpy())
    assert torch.equal(prng.uniform(k, (4097,), device="cuda").cpu(),
                       prng.uniform(k, (4097,)))
    a = prng.normal(k, (100_000,), device="cuda").cpu()
    b = prng.normal(k, (100_000,))
    spacing = torch.nextafter(b.abs(), torch.tensor(math.inf)) - b.abs()
    assert float(((a - b).abs() / spacing).max()) <= 4



def test_train_step_on_card_matches_the_cpu(gen):
    """One flat train step of qwen2-0.5b-smoke on the card (kernels) and on
    the CPU (plain versions) from the same weights. The losses agree to
    float32 rounding; the weights to 3e-4: a loss ulp (4.8e-7) moves a
    coefficient by d·ulp/μ ≈ 17 here, and a weight by up to lr/b2·17·|v_i|
    ≈ 3.5e-5 per direction (|v_i| ≤ 8e-3 of a unit direction in 361,600
    dims), so two ulps on each of the 4 directions give 3e-4."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.core import fedzo
    from repro_torch.models import api
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    model = api.build(get_config("qwen2-0.5b-smoke"))
    step = fedzo.make_train_step(model.loss, FedZOConfig(
        lr=1e-3, mu=1e-2, b2=4, flat_params=True))
    init = model.init(prng.key(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 17), dtype=np.int32))
    out = {}
    for dev in ("cuda", "cpu"):
        spec = flat_spec(init)
        params = unflatten(flatten(init, spec).to(dev), spec)
        batch = {"tokens": tok[:, :-1].to(dev), "labels": tok[:, 1:].to(dev)}
        new, mets = step(params, batch, prng.key(3))
        out[dev] = (flatten(new, spec).cpu(), float(mets["loss"]))
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * out["cpu"][1]
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 3e-4
