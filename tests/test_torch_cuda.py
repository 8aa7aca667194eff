"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False (the check runs inside the fixture, never at import). On a machine
with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The sign kind and the AirComp mean are bitwise; the normal kind within 4
ulp of the summed terms; the norms within a relative 1e-5. ``chip_smoke.py``
repeats these at the main path's full shapes and times them.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import zo_aircomp as zac
from repro_torch.kernels import zo_axpy as za

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
    assert ops.LAUNCHES == {"zo_walk": 1, "zo_replay": 1, "zo_dirnorms": 1,
                            "aircomp_reduce": 1}
