"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False (the check runs inside the fixture, never at import). On a machine
with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The sign kind, the AirComp mean and the two axpys (any dtype mix, ragged
length, view offset) are bitwise; the normal kind within 4 ulp of the
summed terms; the norms within a relative 1e-5, and bitwise the torch twin
of their summation order (``dirnorm_order_sum``, ``aircomp_sq_order_sum``).
RMSNorm and flash attention: float32 within a relative 1e-5 (another
summation order), bfloat16 within 1 bf16 ulp of the output; RMSNorm (both
dtypes, one scale or a ``[G, D]`` scale) and float32 flash attention also
bitwise their summation order's torch twin; attention at every head dim
it builds (8 in float32, 16 to 256), and over more batch rows than grid.z
holds. The client-batched LM and classifier losses against each client's
own loss; bfloat16 normals bitwise the CPU's, and the transformer track's
rounds (also with bfloat16 directions) within 1e-3 of the CPU's. The
autograd wrappers of RMSNorm and attention (their backward bitwise the
plain version's autograd), strategy and FedAvg rounds against the CPU, and
the seed aggregate's launch counts. Under faults: a poisoned upload
bitwise a masked one through ``aircomp_reduce`` and ``zo_walk``, the
poison reaching the weights with the guard off (also from a zero-
coefficient row), and kill-and-resume bitwise on the card.
``chip_smoke.py`` repeats these at the main path's full shapes and times
them.
"""
import itertools
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import zo_aircomp as zac
from repro_torch.kernels import zo_axpy as za
from repro_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

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


# 10 chunks of 1,024 (4 evaluations a thread) and a ragged 5; 4,097 chunks
# of 16,384 (64 a thread), more partials than the finish has threads
@pytest.mark.parametrize("d,rtol", [(10 * 1024 + 5, 1e-5),
                                    # a float32 sum of thousands of partials
                                    # on each side, as at full width
                                    (2 ** 26 + 3, 1e-4)])
def test_zo_dirnorms_in_its_kernel_order_on_card(gen, d, rtol):
    """One launch per call: within the plain version's tolerance, bitwise
    the twin of its summation order (sign kind: the plain directions;
    normal kind: the kernels' own directions), bitwise over two calls, and
    no host synchronisation inside the call."""
    keys = _keys(gen, 2)
    b2 = 3
    per, chunks = za.dirnorm_geometry(d, 2 * b2)
    assert chunks == (11 if d < 2 ** 26 else 4097)
    ops.zo_dirnorms(keys, d, b2=b2)          # builds on first use
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {kind: ops.zo_dirnorms(keys, d, b2=b2, kind=kind)
               for kind in ("normal", "sign")}
        again = ops.zo_dirnorms(keys, d, b2=b2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["zo_dirnorms"] == 3
    assert torch.equal(got["normal"], again)
    for kind in ("normal", "sign"):
        torch.testing.assert_close(
            got[kind], za.zo_dirnorms_plain(keys, d, b2=b2, kind=kind),
            rtol=rtol, atol=0)
    assert torch.equal(got["sign"], za.zo_dirnorms_kernel_order(
        keys, d, b2=b2, kind="sign"))
    # the kernels' own normal directions (zo_walk of zeros), their squares
    # summed by the twin
    assert torch.equal(got["normal"], chip_smoke.dirnorms_from_walk(
        torch, ops, za, keys, d, b2))


@pytest.mark.parametrize("m,n,offset", [
    (10, 65536, 0), (10, 1000, 0),
    (10, 65536 + 77, 0),      # ragged N: scalar loads, masked tail
    (4, 65536, 1),            # a view one element past 16 bytes
    (3, 5 * 4096 + 12, 0),    # aligned rows over a ragged last tile
    (1600, 2048, 0),          # above the previous design's 1,536 rows
    (4, 1 << 22, 0),          # many tiles a block (the wide tiles)
])
def test_aircomp_reduce_on_card(gen, m, n, offset):
    """One launch: the mean bitwise the plain version (rows added in
    ascending order from zero), the norms within 1e-5 relative of the plain
    version's blocked order and bitwise the torch twin of the kernel's own
    order, for the launch geometry the wrapper picks; the same result from
    a second call (the ticket was reset)."""
    base = torch.randn(m * n + offset, generator=gen, device="cuda") * 1e-3
    x = base[offset:].view(m, n)
    s = torch.rand(m, generator=gen, device="cuda")
    d = min(n, 7850) if n < 1 << 20 else n - 5
    ops.reset_launches()
    mean, sq = ops.aircomp_reduce(x, s, d)
    assert ops.LAUNCHES["aircomp_reduce"] == 1
    pmean, psq = zac.aircomp_reduce_plain(x, s, d)
    assert torch.equal(mean, pmean)
    torch.testing.assert_close(sq, psq, rtol=1e-5, atol=0)
    per, grid = ops.aircomp_geometry(n, x.device)
    assert torch.equal(sq, zac.aircomp_sq_order_sum(x, d, per=per,
                                                    grid=grid))
    mean2, sq2 = ops.aircomp_reduce(x, s, d)
    assert torch.equal(mean2, mean) and torch.equal(sq2, sq)


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
    ops.axpy(x, x, 0.5)
    ops.axpy2(x, x, x, 0.5, 0.25)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"zo_walk": 1, "zo_replay": 1, "zo_dirnorms": 1,
                            "aircomp_reduce": 1, "zo_axpy": 1, "zo_axpy2": 1,
                            "rmsnorm": 1, "flash_attention": 1}


# x, u and v each float32 or bfloat16: a bfloat16 tree-convention direction
# moves float32 weights
_AXPY_DTYPES = list(itertools.product((torch.float32, torch.bfloat16),
                                      repeat=3))


@pytest.mark.parametrize("dts", _AXPY_DTYPES,
                         ids=lambda d: "-".join(str(t)[6:] for t in d))
@pytest.mark.parametrize("n", [1, 7, 4096, 65537,
                               # one block's unrolled body (256 threads x 4
                               # vectors x 4 or 8 elements) and its edges
                               4095, 4097, 8191, 8192, 8193, 2 * 8192 + 1])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 0, 5)])
def test_axpy_kernels_on_card(gen, dts, n, offsets):
    """Bitwise against the plain versions: x, u, v views at the given
    element offsets (all 0: 16-byte vectors, then a scalar tail; any other:
    the scalar loop throughout, since the output is freshly allocated) and
    a ragged length, also at the edges of a block's unrolled body."""
    def view(dt, off):
        base = torch.randn(n + off, generator=gen, device="cuda").to(dt)
        return base[off:]

    x, u, v = (view(dt, off) for dt, off in zip(dts, offsets))
    a, b = torch.randn(2, generator=gen, device="cuda")
    got = ops.axpy(x, u, a)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, za.zo_axpy_plain(x, u, a))
    got = ops.axpy2(x, u, v, a, b)
    assert got.dtype == x.dtype
    assert torch.equal(got, za.zo_axpy2_plain(x, u, v, torch.stack([a, b])))


def test_axpy_reads_its_scalar_on_the_card_without_a_sync(gen):
    """A scalar that lives on the card is read by the kernel: no launch of
    the pytree route's perturbation or update waits for the host."""
    x = torch.randn(3, 1000, generator=gen, device="cuda")
    u = torch.randn(3, 1000, generator=gen, device="cuda")
    a = torch.randn((), generator=gen, device="cuda")
    ops.axpy(x, u, a)                       # builds on first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.axpy(x, u, a)
        got2 = ops.axpy2(x, u, u, a, -a)
        tree = ops.tree_axpy2({"w": {"x": x}}, {"w": {"x": u}},
                              {"w": {"x": u}}, a, -a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, za.zo_axpy_plain(x, u, a))
    assert torch.equal(got2, za.zo_axpy2_plain(x, u, u, torch.stack([a, -a])))
    assert torch.equal(tree["w"]["x"], got2)
    with pytest.raises(ValueError, match="float32"):
        ops.axpy(x, u.half(), a)
    with pytest.raises(ValueError, match="contiguous"):
        ops.axpy(x.t(), u.t(), a)


def _bf16_ulps(got, want, floor):
    w = want.float().abs().clamp_min(floor)
    _, e = torch.frexp(w)
    spacing = torch.ldexp(torch.ones_like(w), e - 8)
    return float(((got.float() - want.float()).abs() / spacing).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(512, 896), (7, 64), (1, 100),
                                    (513, 32), (7168, 64)])
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
@pytest.mark.parametrize("groups,lead,d", [
    (1, (512,), 896), (4, (4, 512), 896),  # the batched Qwen2 forward
    (3, (3, 2, 16, 4), 32),                # a batched qk_norm, 8 lanes a row
    (3, (3, 7), 100),                      # rows that are not 16-byte vectors
    (2, (2, 3), 2100),                     # the streaming kernel
    (5, (5, 1), 64),                       # one row a group
    (200, (200, 25, 8), 32),               # the wide classifier cohort
])
def test_rmsnorm_group_scale_on_card(gen, dtype, groups, lead, d):
    """A ``[G, D]`` scale, taken as a strided view (a layer's slice of
    stacked ``[G, L, D]`` scales): bitwise the kernel-order twin and, group
    by group, the one-scale kernel on the group's rows."""
    x = torch.randn(*lead, d, generator=gen, device="cuda").to(dtype)
    stacked = (1 + 0.1 * torch.randn(groups, 3, d, generator=gen,
                                     device="cuda")).to(dtype)
    sc = stacked[:, 1] if groups > 1 else stacked[0, 1]
    got = ops.rmsnorm(x, sc)
    assert torch.equal(got, rn.rmsnorm_kernel_order(x, sc))
    if groups > 1:
        for g in range(groups):
            assert torch.equal(got[g], ops.rmsnorm(x[g], sc[g].clone()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [
    (512, 896, 0), (7, 64, 0), (1, 100, 0), (513, 32, 0), (7168, 64, 0),
    # rows not 16-byte vectors: a view at an odd element offset, a row
    # length whose bytes are not a multiple of 16, one too long for the
    # registers (the streaming kernel)
    (512, 896, 1), (7168, 64, 3), (5, 100, 1), (3, 2100, 0), (3, 2100, 1),
    (4, 4104, 0)])
def test_rmsnorm_in_its_kernel_order_on_card(gen, dtype, rows, d, offset):
    """Bitwise ``rmsnorm_kernel_order`` (the kernel's summation order in
    torch), whichever loads the row takes."""
    base = torch.randn(rows * d + offset, generator=gen, device="cuda")
    x = base.to(dtype)[offset:].view(rows, d)
    sc = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    got = ops.rmsnorm(x, sc)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, rn.rmsnorm_kernel_order(x, sc))
    assert torch.equal(ops.rmsnorm(x.contiguous().clone(), sc), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", [
    (4, 128, 14, 2, 64, True, 0),    # the Qwen2-0.5B train step
    (2, 100, 14, 2, 64, True, 0),    # ragged S, G = 7
    (2, 128, 4, 2, 32, True, 32),    # window, G = 2
    (1, 100, 4, 2, 32, False, 0),    # non-causal, ragged
    (1, 70, 2, 1, 128, True, 0),     # head dim 128
    (2, 16, 4, 2, 32, True, 0),      # the smoke model
    (1, 512, 14, 2, 64, True, 0),    # causal, 8 K/V tiles (double buffer)
    (1, 1000, 4, 2, 64, True, 256),  # ragged S over 16 tiles, window 256
    (2, 128, 4, 4, 64, True, 0),     # G = 1 (Hq = Hkv)
    (1, 33, 4, 1, 32, False, 0),     # Sq not a multiple of a q tile, G = 4
    (1, 300, 2, 2, 128, True, 0),    # head dim 128 over 5 ragged tiles
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b,s,hq,hkv,causal,window", [
    (4, 128, 14, 2, True, 0),     # the main shape's heads
    (2, 100, 4, 1, True, 24),     # ragged, window, G = 4
    (1, 130, 2, 2, False, 0),     # non-causal over 3 ragged tiles, G = 1
    (1, 300, 4, 2, True, 0),      # 5 tiles: both staging schemes cycle
])
def test_attention_head_dims_on_card(gen, dtype, hd, b, s, hq, hkv, causal,
                                     window):
    """Every head dim the kernel builds, both bodies, against the plain
    version: float32 within 1e-5 of max |out|; bfloat16 within 1 bf16 ulp,
    or 1 + r where the plain version's own float32 rounding puts it r > 1
    ulp from the float64 values (``chip_smoke.bf16_attention_errs``, the
    rule of the bf16 design's CPU test)."""
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
        u, r, _ = chip_smoke.bf16_attention_errs(torch, q, k, v, got, want,
                                                 causal, window)
        assert u <= (1 if r <= 1 else 1 + r)


def flash_f32_row_order(q, k, v, *, causal=True, window=0, block_k=64):
    """The float32 kernel's arithmetic (``csrc/flash_attention.cu:
    flash_fwd_f32``) in torch, on any device: q times the float32 scale;
    each score summed over ascending d; per 64-key tile the reference's
    online-softmax update, with the sum of p and every output column taken
    over ascending keys; every term a float32 multiply and then a float32
    add, as torch's elementwise ops round them. On the card it is the
    kernel bit for bit (torch.exp and the kernel's expf are one function
    there); on the CPU, where exp is another, it agrees to rounding."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32,
                         device=dev)
    qs = (q * scale).permute(0, 2, 1, 3)  # [B, Hq, Sq, D]
    kk, vv = (t.repeat_interleave(Hq // Hkv, 2).permute(0, 2, 1, 3)
              for t in (k, v))
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Hq, Sq), -1e30, device=dev)
    l = torch.zeros(B, Hq, Sq, device=dev)
    acc = torch.zeros(B, Hq, Sq, D, device=dev)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        s = torch.zeros(B, Hq, Sq, k1 - k0, device=dev)
        for d in range(D):
            s = s + qs[..., d:d + 1] * kk[:, :, None, k0:k1, d]
        k_pos = torch.arange(k0, k1, device=dev)[None, :]
        ok = torch.ones(Sq, k1 - k0, dtype=torch.bool, device=dev)
        if causal:
            ok &= q_pos >= k_pos
        if window:
            ok &= q_pos - k_pos < window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * corr[..., None]
        psum = torch.zeros_like(l)
        for j in range(k1 - k0):
            psum = psum + p[..., j]
            acc = acc + p[..., j, None] * vv[:, :, None, k0 + j]
        l = l * corr + psum
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).contiguous()


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", [
    (4, 128, 14, 2, 64, True, 0),    # the Qwen2-0.5B train step
    (2, 100, 14, 2, 64, True, 0),    # ragged S
    (2, 128, 4, 2, 32, True, 32),    # window, head dim 32
    (1, 100, 4, 2, 32, False, 0),    # non-causal, ragged
    (1, 300, 2, 2, 128, True, 0),    # head dim 128, causal tiles skipped
    (1, 1000, 4, 2, 64, True, 256),  # whole tiles outside the window
    (2, 100, 4, 2, 16, True, 0),     # head dim 16
    (1, 200, 2, 1, 256, True, 48),   # head dim 256, one staging buffer
    (250, 8, 2, 2, 8, True, 0),      # the classifier's flat cohort, D = 8
    (3, 100, 4, 2, 8, True, 24),     # head dim 8, ragged, window, G = 2
])
def test_flash_f32_sums_in_row_order_on_card(gen, b, s, hq, hkv, hd, causal,
                                            window):
    """The float32 kernel spreads a row's work over 16 lanes but keeps the
    summation order of one thread per row, so it equals that order's
    torch twin bit for bit (its rounding is what decides which full-width
    ZO coefficients are nonzero)."""
    q = torch.randn(b, s, hq, hd, generator=gen, device="cuda")
    k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
    v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = flash_f32_row_order(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window", [
    (250, 8, 2, 2, 8, True, 0),      # the classifier at its test size
    (250, 8, 2, 2, 16, True, 0),     # the track's default width, flat
    (5000, 8, 2, 2, 16, True, 0),    # its wide cohort: M.b2.b1 rows
    (1, 130, 2, 2, 8, False, 0),     # head dim 8 over 3 ragged tiles
    (2, 300, 4, 1, 8, True, 0),      # 5 tiles, G = 4
])
def test_attention_classifier_shapes_on_card(gen, b, s, hq, hkv, hd, causal,
                                             window):
    """float32 at the neural transformer track's shapes (S = 8 patch
    tokens: a q tile of 32 rows mostly empty) and head dim 8, within 1e-5
    of max |out| of the plain version."""
    q = torch.randn(b, s, hq, hd, generator=gen, device="cuda")
    k = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
    v = torch.randn(b, s, hkv, hd, generator=gen, device="cuda")
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_batch_beyond_grid_z_on_card(gen, dtype):
    """70,000 batch rows (grid.z holds 65,535): the batch is folded into
    grid.x, and every row is its own call's result bit for bit."""
    b, s, h, hd = 70_000, 8, 2, 16
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    got = ops.attention(q, k, v)
    for i in (0, 1, 65_535, 65_536, b - 1):
        one = ops.attention(q[i:i + 1].clone(), k[i:i + 1].clone(),
                            v[i:i + 1].clone())
        assert torch.equal(got[i:i + 1], one), i


def test_attention_bf16_head_dim_8_raises_on_card(gen):
    q = torch.randn(2, 8, 2, 8, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim 8"):
        ops.attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_on_card_takes_misaligned_views(gen, dtype):
    """q, k and v as contiguous views one element past a 16-byte boundary:
    the wrapper copies them to aligned tensors for the kernel's 16-byte
    loads, and the result is that of the aligned inputs."""
    shapes = ((2, 100, 14, 64), (2, 100, 2, 64), (2, 100, 2, 64))
    views = []
    for shape in shapes:
        n = math.prod(shape)
        buf = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        views.append(buf[1:].view(shape))
    q, k, v = views
    assert all(t.data_ptr() % 16 for t in views)
    got = ops.attention(q, k, v)
    want = ops.attention(q.clone(), k.clone(), v.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


def test_bf16_normals_on_card_match_the_cpu(gen):
    """bfloat16 normals, the tree convention's bf16 draws, bitwise the
    CPU's over ragged shapes (``chip_smoke.check_bf16_draws``)."""
    chip_smoke.check_bf16_draws(torch)


@pytest.mark.parametrize("route", ["flat", "pytree", "pytree bf16 sphere",
                                   "pytree bf16 gaussian", "wide"])
def test_track_rounds_on_card_match_the_cpu(gen, route):
    """2 rounds of the transformer track at its test size on the card and
    on the CPU from one seed, exact launch counts on the card, the weights
    within 1e-3 (``chip_smoke.check_track_small_reference``); the bf16
    routes put float32 weights and bfloat16 directions through zo_axpy."""
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.workloads import neural

    chip_smoke.check_track_small_reference(torch, ops, neural, FedZOConfig,
                                           route)



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


def test_pytree_train_step_on_card_matches_the_cpu(gen):
    """One pytree train step of qwen2-0.5b-smoke (the launcher's route:
    tree-convention sphere directions, one zo_axpy per leaf per
    perturbation and update) on the card and on the CPU from the same
    weights: 2·b2·14 zo_axpy launches, and the weights within the flat
    step's 3e-4 (the same loss-ulp argument)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.core import fedzo
    from repro_torch.models import api
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    model = api.build(get_config("qwen2-0.5b-smoke"))
    step = fedzo.make_train_step(model.loss, FedZOConfig(lr=1e-3, mu=1e-2,
                                                         b2=4))
    init = model.init(prng.key(0), device="cpu")
    spec = flat_spec(init)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 17), dtype=np.int32))
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: v for k, v in unflatten(
            flatten(init, spec).to(dev), spec).items()}
        batch = {"tokens": tok[:, :-1].to(dev), "labels": tok[:, 1:].to(dev)}
        ops.reset_launches()
        new, mets = step(params, batch, prng.key(3))
        out[dev] = (flatten(new, spec).cpu(), float(mets["loss"]),
                    dict(ops.LAUNCHES))
    assert out["cuda"][2]["zo_axpy"] == 2 * 4 * len(spec.paths)
    assert out["cpu"][2]["zo_axpy"] == 0
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * out["cpu"][1]
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 3e-4


def test_batched_lm_loss_on_card_matches_each_client(gen):
    """The client-batched forward of qwen2-0.5b-smoke (M = 3 clients' own
    weights, as views of one ``[M, n_pad]`` buffer) on the card: 2L + 1
    RMSNorm and L attention launches whatever M is, and each client's loss
    within 4 float32 ulps of its own ``Model.loss`` (the batched GEMMs may
    take other cuBLAS algorithms than the single ones; the RMSNorm and
    attention launches are bitwise per client)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    cfg = get_config("qwen2-0.5b-smoke")
    model = api.build(cfg)
    init = model.init(prng.key(0), device="cuda")
    spec = flat_spec(init)
    m = 3
    buf = flatten(init, spec)[None].repeat(m, 1)
    buf = buf + 1e-2 * torch.randn(buf.shape, generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab, (m, 2, 17), generator=gen,
                        device="cuda")
    batch = {"tokens": tok[..., :-1], "labels": tok[..., 1:]}
    ops.reset_launches()
    got = model.loss_batched(unflatten(buf, spec), batch)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert ops.LAUNCHES["rmsnorm"] == 2 * L + 1
    assert ops.LAUNCHES["flash_attention"] == L
    each = torch.stack([model.loss(unflatten(buf[i], spec),
                                   {k: t[i] for k, t in batch.items()})
                        for i in range(m)])
    ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
    assert float(((got - each).abs() / ulp).max()) <= 4


def test_batched_classifier_loss_on_card_matches_each_client(gen):
    """The neural transformer track's client-batched loss on the card at
    its default width (d_model 32, 2 heads of 16, 8 patch tokens): M = 3
    clients, and the wide route's r = 4 copies of each client sharing its
    batch. 2L + 1 RMSNorm and L attention launches per call, and each row
    within 4 float32 ulps of its own loss."""
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten
    from repro_torch.workloads import neural

    task = neural.make_task("transformer", device="cuda", n_train=120,
                            n_test=16, n_clients=3)
    init = neural.params_init(task, 0)
    spec = flat_spec(init)
    m, r = 3, 4
    x = torch.rand(m, 5, 784, generator=gen, device="cuda")
    y = torch.randint(0, 10, (m, 5), generator=gen, device="cuda")
    for reps in (1, r):
        buf = flatten(init, spec)[None].repeat(m * reps, 1)
        buf = buf + 1e-2 * torch.randn(buf.shape, generator=gen,
                                       device="cuda")
        ops.reset_launches()
        got = task.loss.batched(unflatten(buf, spec), {"x": x, "y": y})
        torch.cuda.synchronize()
        assert ops.LAUNCHES["rmsnorm"] == 3
        assert ops.LAUNCHES["flash_attention"] == 1
        each = torch.stack([task.loss(unflatten(buf[i], spec),
                                      {"x": x[i // reps], "y": y[i // reps]})
                            for i in range(m * reps)])
        ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
        assert float(((got - each).abs() / ulp).max()) <= 4


@pytest.mark.parametrize("case", range(len(chip_smoke.BACKWARD_CASES)))
def test_autograd_backward_on_card(gen, case):
    """``ops.rmsnorm`` and ``ops.attention`` with inputs that require a
    gradient on the card: the forward is the kernel (one launch, bitwise
    its direct call), the gradients (the backward recomputes the plain
    version) bitwise autograd of the plain version on the same tensors, in
    float32 and bfloat16, with a ``[G, D]`` scale, at head dims 8 to 256
    (``chip_smoke.check_backward``)."""
    kind, shape, dt = chip_smoke.BACKWARD_CASES[case]
    chip_smoke.check_backward(torch, ops, kind, shape, getattr(torch, dt),
                              gen)


@pytest.mark.parametrize("name", ["fedprox", "scaffold", "fedavg"])
def test_strategy_rounds_on_card_match_the_cpu(gen, name):
    """One round of the transformer track at its test size under fedprox
    (flat), scaffold (wide) and fedavg on the card and on the CPU: exact
    launch counts, the weights within 1e-3 (ZO) or 1e-5 (FedAvg, whose
    gradient flows through the kernels' autograd wrappers)
    (``chip_smoke.check_strategy_small_reference``)."""
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.workloads import neural

    chip_smoke.check_strategy_small_reference(torch, ops, neural,
                                              FedZOConfig, name)


def test_fedavg_gradient_on_card_matches_the_cpu(gen):
    """One client's FedAvg gradient of the transformer track at its
    default width on the card against the CPU's, every leaf within 1e-4 of
    its largest entry (``chip_smoke.check_fedavg_gradient``)."""
    from repro_torch.workloads import neural

    track = neural.make_task("transformer", device="cuda", n_train=200,
                             n_test=16, n_clients=4)
    chip_smoke.check_fedavg_gradient(torch, ops, neural, track)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "pytree"])
def test_seed_aggregate_launches_on_card(gen, flat):
    """``seedcomm.aggregate`` of M = 3 messages (H = 2, b2 = 4) on the card:
    on the flat route exactly 1 zo_dirnorms and M·H zo_replay, on the
    pytree route b2 zo_axpy per leaf per record; the replay within
    relative 1e-5 of the CPU's (the card's Box-Muller within a few ulps)."""
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.core import seedcomm
    from repro_torch.models import simple

    m, h, b2 = 3, 2, 4
    cfg = FedZOConfig(local_iters=h, b2=b2, flat_params=flat,
                      flat_block_rows=4)
    keys = prng.split(prng.key(3), m)
    coeffs = torch.randn(m, h, b2, generator=gen, device="cuda") * 50
    out = {}
    for dev in ("cuda", "cpu"):
        params = simple.softmax_init(24, 4, device=dev)
        msgs = seedcomm.compress_stacked(keys, coeffs.to(dev), cfg)
        ops.reset_launches()
        out[dev] = seedcomm.aggregate(msgs, params, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            want = dict.fromkeys(ops.LAUNCHES, 0)
            if flat:
                want.update(zo_dirnorms=1, zo_replay=m * h)
            else:
                want.update(zo_axpy=m * h * b2 * len(params))
            assert dict(ops.LAUNCHES) == want
    big = max(float(v.abs().max()) for v in out["cpu"].values())
    for k, v in out["cpu"].items():
        assert float((out["cuda"][k].cpu() - v).abs().max()) <= 1e-5 * big


def _faulted_round_inputs(device, m=4):
    """Softmax 784x10 on 12 clients, one round's batches and keys for M
    clients (H = 2, b2 = 6), on ``device``."""
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.sim.store import sample_batches, sample_participants
    from repro_torch.workloads import neural

    task = neural.make_task("softmax", n_train=600, n_test=60,
                            n_features=784, n_classes=10, n_clients=12,
                            device=device)
    cfg = FedZOConfig(n_devices=12, n_participating=m, local_iters=2, b1=8,
                      b2=6, flat_params=True, aircomp=True, snr_db=5.0)
    ks = prng.split(prng.key(5), 3)
    idx = sample_participants(ks[0], 12, m)
    batches = sample_batches(task.store, idx, ks[1], 2, 8)
    return (task, cfg, neural.params_init(task, 0), batches,
            prng.split(ks[2], m))


@pytest.mark.parametrize("aircomp", [True, False], ids=["aircomp", "mean"])
def test_poisoned_equals_masked_on_card(gen, aircomp):
    """Softmax 784x10 (n_pad 65,536), M = 4: a NaN upload with the guard
    on gives weights bitwise those of the round with that client masked,
    through ``aircomp_reduce`` and the noise ``zo_walk`` (or the masked
    mean), with the plain round's launches; the poisoned round on the card
    within 1e-3 of the CPU's (at the default lr 1e-3 the weights move by
    up to 0.028 in the round; port against the reference on the CPU reads
    2.4e-5: a loss ulp moves a ZO coefficient by d·ulp/μ ≈ 1.9 here)."""
    import dataclasses

    from repro_torch.core import fedzo
    from repro_torch.sim import FaultModel, RoundFaults

    bad = torch.tensor([False, True, False, False])
    rfs = {"poisoned": RoundFaults(FaultModel(p_corrupt=0.5),
                                   torch.ones(4, dtype=torch.bool), bad),
           "masked": RoundFaults(FaultModel(), ~bad, torch.zeros_like(bad))}
    out = {}
    for dev in ("cuda", "cpu"):
        task, cfg, p0, batches, rngs = _faulted_round_inputs(dev)
        cfg = dataclasses.replace(cfg, aircomp=aircomp)
        for name, rf in rfs.items():
            if dev == "cpu" and name == "masked":
                continue
            ops.reset_launches()
            out[dev, name] = fedzo.round_simulated(
                task.loss, p0, batches, rngs, cfg, channel_rng=prng.key(2),
                faults=rf)
            if dev == "cuda":
                torch.cuda.synchronize()
                assert dict(ops.LAUNCHES) == chip_smoke.round_launches(
                    ops, cfg, 1)
    for k, v in out["cuda", "poisoned"][0].items():
        assert bool(torch.isfinite(v).all())
        assert torch.equal(v, out["cuda", "masked"][0][k]), k
        assert float((v.cpu() - out["cpu", "poisoned"][0][k]).abs().max()) \
            <= 1e-3, k
    assert float(out["cuda", "poisoned"][1]["m_effective"]) == 3.0


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_guard_off_poison_reaches_weights_on_card(gen, mode):
    """The guard off: a NaN upload NaNs the AirComp mean and Δ_max; an Inf
    upload from a client the channel masks (row coefficient 0) still NaNs
    the mean, as 0·inf does in the reference's einsum: no kernel skips a
    zero-coefficient row, no max swallows a NaN."""
    from repro_torch.core import fedzo
    from repro_torch.sim import ChannelModel, FaultModel, RoundChannel
    from repro_torch.sim import RoundFaults

    task, cfg, p0, batches, rngs = _faulted_round_inputs("cuda")
    bad = torch.tensor([False, True, False, False])
    chan = RoundChannel(ChannelModel(), torch.ones(4, dtype=torch.complex64),
                        ~bad if mode == "inf" else torch.ones(
                            4, dtype=torch.bool))
    new, met = fedzo.round_simulated(
        task.loss, p0, batches, rngs, cfg, channel_rng=prng.key(2),
        channel=chan, faults=RoundFaults(
            FaultModel(p_corrupt=0.5, corrupt_mode=mode, guard=False),
            torch.ones(4, dtype=torch.bool), bad))
    assert not all(bool(torch.isfinite(v).all()) for v in new.values())
    assert math.isfinite(float(met["delta_max"])) == (mode == "inf")


def test_kill_and_resume_bitwise_on_card(gen, tmp_path):
    """Softmax 24x4 under faults and an energy-gated channel on the card:
    6 rounds in 2-round segments, and killed after 2 segments then
    resumed, are bitwise the single-shot run (weights, metrics, evals,
    key, chains)."""
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.sim import ChannelModel, FaultModel
    from repro_torch.workloads import neural

    task = neural.make_task("softmax", n_train=320, n_test=96, n_clients=6,
                            n_features=24, n_classes=4, alpha=0.5,
                            device="cuda")
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=8,
                      b2=4, lr=5e-2, seed=11, flat_params=True,
                      flat_block_rows=4, aircomp=True, channel_schedule=True,
                      h_min=0.3, channel_model=ChannelModel(
                          rho=0.8, battery=4.0, tx_cost=1.0))
    kw = dict(faults=FaultModel(p_fail=0.2, p_recover=0.5, p_corrupt=0.2),
              eval_rows=96)
    one = neural.run(task, cfg, 6, **kw)
    chunked = neural.run(task, cfg, 6, checkpoint_every=2,
                         checkpoint_dir=str(tmp_path / "a"), **kw)
    d = str(tmp_path / "b")
    assert neural.run(task, cfg, 6, checkpoint_every=2, checkpoint_dir=d,
                      max_segments=2, **kw).rounds == 4
    resumed = neural.run(task, cfg, 6, checkpoint_every=2, checkpoint_dir=d,
                         resume=True, **kw)
    assert chip_smoke._same_run(torch, one, chunked)
    assert chip_smoke._same_run(torch, one, resumed)
