"""The pytree route's building blocks against the JAX package: the plain
versions of ``zo_axpy``/``zo_axpy2`` (against the Pallas kernels in
interpret mode and the oracles of ``kernels/ref.py``), the tree helpers,
the estimator's pytree half, the pytree AirComp forms, the embedding
lookup's out-of-range semantics and the checkpoint format.

Inputs come from numpy seeds and go to both packages. Integer work (key
derivation, sign and coordinate directions, masks) is bitwise. Normal
draws agree within 4 float32 ulp (the port evaluates XLA's erfinv
polynomial; log1p and the rounding order differ). Each other tolerance is
stated beside its assertion with its reason.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import FedZOConfig as JConfig
from repro.core import aircomp as jair
from repro.core import estimator as jest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import zo_axpy as jza
from repro.models import layers as jlayers
from repro.utils import tree as jtree
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs.base import FedZOConfig as TConfig
from repro_torch.core import aircomp as tair
from repro_torch.core import estimator as test_
from repro_torch.kernels import ops as tops
from repro_torch.kernels import zo_axpy as tza
from repro_torch.models import layers as tlayers
from repro_torch.utils import convert, prng
from repro_torch.utils import tree as ttree

BLOCK = 1024                 # the Pallas block of the direct kernel calls


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path is thousands of small tensor ops. One intra-op
    thread runs them as fast, and leaves the other test workers' cores
    alone: eight threads per op wait on each other when the cores are
    shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _spacing(want, dtype):
    """The spacing of ``dtype`` (f32 or bf16) at |want| (float64 array)."""
    _, e = np.frexp(np.maximum(np.abs(np.asarray(want, np.float64)),
                               1e-30))
    return np.ldexp(1.0, e - (24 if dtype == "f32" else 8))


def _ulps(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / _spacing(want, dtype)))


def _terms_ulps(got, want, scale, dtype):
    """max |got - want| in spacings of ``dtype`` at |scale|, the magnitude
    of the summed terms."""
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))
                        / _spacing(scale, dtype)))


def _vec(rs, n, dtype, scale=1.0):
    """The same values as a jax array and a tensor of ``dtype``."""
    x = (rs.normal(0, scale, n)).astype(np.float32)
    return (jnp.asarray(x).astype(DT[dtype][0]),
            torch.from_numpy(x).to(DT[dtype][1]))


def _np(t):
    """float64 numpy of a jax array or a tensor of any float dtype."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


# ---------------------------------------------------------------------------
# the two kernels' plain versions


def _check_axpy(got, oracle, kernel, scale, xd, terms=1):
    """Bitwise against the oracle, which rounds each product and each sum
    one at a time as the plain version does. Against the interpret-mode
    kernel within ``terms`` ulps (of x's dtype) of the summed terms: XLA's
    CPU backend contracts each multiply-add of the kernel body into one FMA
    (measured: 32 % of float32 elements of x + a·u differ by that one
    rounding; with two terms the two roundings add up to 2 ulp)."""
    assert got.dtype == DT[xd][1] and oracle.dtype == kernel.dtype \
        == DT[xd][0]
    np.testing.assert_array_equal(_np(got), _np(oracle))
    assert _terms_ulps(_np(got), _np(kernel), scale, xd) <= terms


@pytest.mark.parametrize("xd,ud", [("f32", "f32"), ("bf16", "bf16"),
                                   ("bf16", "f32")])
def test_zo_axpy_plain_matches_pallas_and_oracle(xd, ud):
    rs = np.random.default_rng(0)
    jx, tx = _vec(rs, 2 * BLOCK, xd)
    ju, tu = _vec(rs, 2 * BLOCK, ud)
    a = np.float32(rs.normal())
    got = tza.zo_axpy_plain(tx, tu, torch.tensor([a]))
    _check_axpy(got, jref.axpy_ref(jx, ju, jnp.asarray([a])),
                jza.zo_axpy(jx, ju, jnp.asarray([a]), interpret=True,
                            block=BLOCK),
                np.abs(_np(tx)) + np.abs(a * _np(tu)), xd)
    # the wrapper takes a float, a 0-d or a one-element tensor alike
    for a_arg in (float(a), torch.tensor(a), torch.tensor([a])):
        torch.testing.assert_close(tops.axpy(tx, tu, a_arg), got, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("dts", [("f32", "f32", "f32"),
                                 ("bf16", "bf16", "bf16"),
                                 ("bf16", "f32", "f32"),
                                 ("bf16", "bf16", "f32")])
@pytest.mark.parametrize("n", [1, 7, 3000])
def test_zo_axpy2_plain_matches_reference(dts, n):
    """Ragged n through both packages' ``ops.axpy2`` (the reference pads
    to a block and runs the kernel; the port takes any length), and the
    plain version against the interpret-mode kernel and ``axpy2_ref`` at a
    block multiple. Tolerances as for the one-term form."""
    xd, ud, vd = dts
    rs = np.random.default_rng(n)
    jx, tx = _vec(rs, n, xd)
    ju, tu = _vec(rs, n, ud)
    jv, tv = _vec(rs, n, vd)
    a, b = (float(np.float32(z)) for z in rs.normal(size=2))
    tops.reset_launches()
    got = tops.axpy2(tx, tu, tv, a, b)
    assert tops.LAUNCHES["zo_axpy2"] == 0          # the plain version ran
    want = jops.axpy2(jx, ju, jv, a, b, block=BLOCK)
    assert got.shape == (n,)
    ab = np.asarray([a, b], np.float32)

    def terms(tx, tu, tv):
        return np.abs(_np(tx)) + np.abs(a * _np(tu)) + np.abs(b * _np(tv))

    _check_axpy(got, jref.axpy2_ref(jx, ju, jv, jnp.asarray(ab)), want,
                terms(tx, tu, tv), xd, terms=2)
    jx, tx = _vec(rs, BLOCK, xd)
    ju, tu = _vec(rs, BLOCK, ud)
    jv, tv = _vec(rs, BLOCK, vd)
    got = tza.zo_axpy2_plain(tx, tu, tv, torch.from_numpy(ab))
    _check_axpy(got, jref.axpy2_ref(jx, ju, jv, jnp.asarray(ab)),
                jza.zo_axpy2(jx, ju, jv, jnp.asarray(ab), interpret=True,
                             block=BLOCK), terms(tx, tu, tv), xd, terms=2)


def _tree(seed, dtype=np.float32):
    rs = np.random.default_rng(seed)

    def a(*shape):
        return rs.normal(0, 1, shape).astype(dtype)

    return {"embed": {"tok": a(40, 8)}, "final_norm": {"scale": a(8)},
            "blocks": {"attn": {"wq": a(2, 8, 8), "bq": a(2, 8)},
                       "mlp": {"w_up": a(2, 8, 16)}}}


def test_tree_axpy2_matches_reference():
    """Leaf by leaf over a nested tree, within 2 ulp of the summed terms of
    the reference's kernel (its FMAs, as above)."""
    x, u, v = _tree(0), _tree(1), _tree(2)
    want = jops.tree_axpy2(*(jax.tree.map(jnp.asarray, t) for t in (x, u, v)),
                           0.25, -1.5)
    got = tops.tree_axpy2(*(convert.to_torch(t) for t in (x, u, v)), 0.25,
                          -1.5)
    items = [dict(_flat_items(convert.to_torch(t))) for t in (x, u, v)]
    for (path, w), (tpath, g) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            sorted(_flat_items(got))):
        assert jax.tree_util.keystr(path) == tpath
        tx, tu, tv = (t[tpath] for t in items)
        scale = (np.abs(_np(tx)) + 0.25 * np.abs(_np(tu))
                 + 1.5 * np.abs(_np(tv)))
        assert _terms_ulps(_np(g), _np(w), scale, "f32") <= 2


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            yield from _flat_items(v, name)
        else:
            yield name, v


# ---------------------------------------------------------------------------
# tree helpers and draws


def _assert_trees(got, want, check):
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = sorted(_flat_items(got))
    assert [jax.tree_util.keystr(p) for p, _ in wl] == [n for n, _ in gl]
    for (_, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == tuple(np.shape(w))
        check(g, w)


def test_tree_helpers_match_reference():
    """Sizes exactly; elementwise helpers bitwise; the global sums (dot,
    norm) within 1e-6 of the sum of the terms' magnitudes: a sum per leaf,
    then over the leaves, each in the backend's own order, and the dot
    product cancels (measured: 23 ulp of the result, 2.3e-8 of Σ|x·y|)."""
    x, y = _tree(3), _tree(4)
    jx, jy = jax.tree.map(jnp.asarray, x), jax.tree.map(jnp.asarray, y)
    tx, ty = convert.to_torch(x), convert.to_torch(y)
    assert ttree.tree_size(tx) == jtree.tree_size(jx)
    jmixed = dict(jx, final_norm={"scale": jx["final_norm"]["scale"].astype(
        jnp.bfloat16)})
    tmixed = dict(tx, final_norm={"scale": tx["final_norm"]["scale"].to(
        torch.bfloat16)})
    assert ttree.tree_bytes(tmixed) == jtree.tree_bytes(jmixed)

    def exact(g, w):
        np.testing.assert_array_equal(_np(g), _np(w))

    for jt, tt in ((jtree.tree_add(jx, jy), ttree.tree_add(tx, ty)),
                   (jtree.tree_sub(jx, jy), ttree.tree_sub(tx, ty)),
                   (jtree.tree_scale(0.3, jx), ttree.tree_scale(0.3, tx)),
                   (jtree.tree_zeros_like(jx), ttree.tree_zeros_like(tx)),
                   (jtree.tree_cast(jx, jnp.bfloat16),
                    ttree.tree_cast(tx, torch.bfloat16)),
                   (jtree.tree_axpy(0.7, jx, jy),
                    ttree.tree_axpy(0.7, tx, ty))):
        _assert_trees(tt, jt, exact)
    stacked = ttree.tree_stack([tx, ty])
    _assert_trees(stacked, jtree.tree_stack([jx, jy]), exact)
    for jt, tt in zip(jtree.tree_unstack(jtree.tree_stack([jx, jy]), 2),
                      ttree.tree_unstack(stacked, 2)):
        _assert_trees(tt, jt, exact)
    mag = float(jtree.tree_dot(jax.tree.map(jnp.abs, jx),
                               jax.tree.map(jnp.abs, jy)))
    for jv, tv, m in (
            (jtree.tree_dot(jx, jy), ttree.tree_dot(tx, ty), mag),
            (jtree.tree_sq_norm(jx), ttree.tree_sq_norm(tx),
             float(jtree.tree_sq_norm(jx))),
            (jtree.tree_norm(jx), ttree.tree_norm(tx),
             float(jtree.tree_norm(jx)))):
        assert abs(float(tv) - float(jv)) <= 1e-6 * m


def test_tree_draws_match_reference():
    """Per-leaf keys fold_in(rng, i) in jax's leaf order, over 1-D, 2-D and
    3-D stacked leaves: normals within 4 ulp; the streamed forms against
    the reference's within 4 ulp of the summed terms; the squared norm
    within 1e-6 relative (sums of 4 ulp terms in another order)."""
    params = _tree(5)
    jp, tp = jax.tree.map(jnp.asarray, params), convert.to_torch(params)
    jk, tk = jax.random.key(9), prng.key(9)

    def ulp4(g, w):
        assert _ulps(_np(g), _np(w), "f32") <= 4

    _assert_trees(ttree.normal_like_tree(tk, tp),
                  jtree.normal_like_tree(jk, jp), ulp4)
    _assert_trees(ttree.sphere_like_tree(tk, tp),
                  jtree.sphere_like_tree(jk, jp), ulp4)
    np.testing.assert_allclose(float(ttree.tree_random_sq_norm(tk, tp)),
                               float(jtree.tree_random_sq_norm(jk, jp)),
                               rtol=1e-6)
    coef = 0.05
    want = jtree.tree_add_normal(jp, jk, coef)
    got = ttree.tree_add_normal(tp, tk, coef)
    g = ttree.normal_like_tree(tk, tp)
    for (name, gl), (_, xl), (_, wl) in zip(
            sorted(_flat_items(got)), sorted(_flat_items(tp)),
            sorted(_flat_items(convert.to_torch(jax.device_get(want))))):
        scale = np.abs(_np(xl)) + coef * np.abs(_np(dict(_flat_items(g))[
            name]))
        assert np.max(np.abs(_np(gl) - _np(wl)) / _spacing(scale, "f32")) \
            <= 4, name


def test_rademacher_is_bitwise_jax():
    for seed, shape in ((0, (1000,)), (3, (7, 9)), (5, (2, 3, 4))):
        want = jax.random.rademacher(jax.random.key(seed), shape,
                                     jnp.float32)
        got = prng.rademacher(prng.key(seed), shape)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("kind", ["sphere", "gaussian", "rademacher",
                                  "coordinate"])
def test_sample_direction_matches_reference(kind):
    """Sign and coordinate directions bitwise; normal ones within 4 ulp
    (sphere: the global norm adds at most 2 ulp to the scaling)."""
    params = _tree(6)
    jp, tp = jax.tree.map(jnp.asarray, params), convert.to_torch(params)
    for seed in (1, 2):
        want = jest.sample_direction(jax.random.key(seed), jp, kind)
        got = test_.sample_direction(prng.key(seed), tp, kind)
        if kind in ("rademacher", "coordinate"):
            _assert_trees(got, want, lambda g, w: np.testing.
                          assert_array_equal(_np(g), _np(w)))
        else:
            _assert_trees(got, want, lambda g, w: _ulps_le(g, w, 6))


def _ulps_le(g, w, n):
    assert _ulps(_np(g), _np(w), "f32") <= n


@pytest.mark.parametrize("kind", ["sphere", "gaussian", "rademacher"])
def test_counter_direction_tree_matches_reference(kind):
    """The flat counter convention cut into leaves: sign bitwise, normal
    within 4 ulp (Box-Muller's log/cos), sphere within 6 (plus the norm)."""
    params = _tree(7)
    jp, tp = jax.tree.map(jnp.asarray, params), convert.to_torch(params)
    want = jest.counter_direction(jax.random.key(4), 3, jp, kind)
    got = test_.counter_direction(prng.key(4), 3, tp, kind)
    if kind == "rademacher":
        _assert_trees(got, want, lambda g, w: np.testing.assert_array_equal(
            _np(g), _np(w)))
    else:
        _assert_trees(got, want, lambda g, w: _ulps_le(g, w, 6))
    with pytest.raises(ValueError):
        test_.counter_direction(prng.key(4), 3, tp, "coordinate")


@pytest.mark.parametrize("kind", ["sphere", "gaussian", "coordinate"])
def test_stream_perturb_matches_reference(kind):
    """params + mag·v: within 4 ulp of |x| + |mag·v| (the draws' ulps)."""
    params = _tree(8)
    jp, tp = jax.tree.map(jnp.asarray, params), convert.to_torch(params)
    mag = 0.01
    want = jest.stream_perturb(jp, jax.random.key(3), mag, kind)
    got = test_.stream_perturb(tp, prng.key(3), mag, kind)
    _assert_trees(got, want, lambda g, w: _within_terms(g, w, mag))


def _within_terms(g, w, mag):
    scale = np.abs(_np(w)) + 6 * mag
    assert np.max(np.abs(_np(g) - _np(w)) / _spacing(scale, "f32")) <= 4


# ---------------------------------------------------------------------------
# estimator: coefficients and their replay


def _softmax_problem(seed=0, f=24, c=4, b=16):
    rs = np.random.default_rng(seed)
    params = {"w": rs.normal(0, 0.1, (f, c)).astype(np.float32),
              "b": rs.normal(0, 0.1, (c,)).astype(np.float32)}
    batch = {"x": rs.normal(0, 1, (b, f)).astype(np.float32),
             "y": rs.integers(0, c, b).astype(np.int32)}
    return params, batch


def _jloss(p, batch):
    logits = batch["x"] @ p["w"] + p["b"]
    return jnp.mean(jax.nn.logsumexp(logits, -1)
                    - jnp.take_along_axis(logits, batch["y"][:, None],
                                          -1)[:, 0])


def _tloss(p, batch):
    logits = batch["x"] @ p["w"] + p["b"]
    return torch.mean(torch.logsumexp(logits, -1)
                      - torch.gather(logits, -1,
                                     batch["y"].long()[:, None])[:, 0])


@pytest.mark.parametrize("conv,kind,central", [
    ("tree", "sphere", False), ("tree", "gaussian", True),
    ("tree", "rademacher", False), ("tree", "coordinate", False),
    ("counter", "sphere", False), ("counter", "sphere", True)])
def test_coefficients_and_replay_match_reference(conv, kind, central):
    """c_n = scale·(L(x+μv_n) − L(x))/μ: a one-ulp loss difference (torch
    and XLA sum the logits in other orders) moves c_n by scale·ulp/μ, with
    scale = d = 100 for sphere/coordinate and 1 otherwise, ulp(1.4) =
    1.2e-7 and μ = 1e-3: 0.012 or 1.2e-4; the limit is 8 loss ulps
    (measured: at most 3, with the base loss 1 ulp apart). The
    replay gets the same coefficients on both sides, so it differs only by
    the directions' ulps: within 4 ulp of |x| + Σ|s·c_n/b2·v_n|."""
    params, batch = _softmax_problem()
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.to_torch(params)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = convert.to_torch(batch)
    mu, b2 = 1e-3, 6
    jc, jbase = jest.coefficients(_jloss, jp, jb, jax.random.key(2), mu=mu,
                                  b2=b2, kind=kind, central=central,
                                  conv=conv)
    tc, tbase = test_.coefficients(_tloss, tp, tb, prng.key(2), mu=mu, b2=b2,
                                   kind=kind, central=central, conv=conv)
    assert abs(float(tbase) - float(jbase)) <= 2 * np.spacing(
        np.float32(jbase))
    scale = 100.0 if kind in ("sphere", "coordinate") else 1.0
    limit = 8 * scale * float(np.spacing(np.float32(jbase))) / mu
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=limit)
    coeffs = np.array(jc)
    want = jest.apply_coefficients(jp, jax.random.key(2), jnp.asarray(coeffs),
                                   scale=-0.05, kind=kind, conv=conv)
    got = test_.apply_coefficients(tp, prng.key(2), torch.from_numpy(coeffs),
                                   scale=-0.05, kind=kind, conv=conv)
    step = 0.05 * np.abs(coeffs).sum() / b2 * (1.0 if kind == "sphere"
                                               else 6.0)
    _assert_trees(got, want, lambda g, w: _within_step(g, w, step))


def _within_step(g, w, step):
    scale = np.abs(_np(w)) + step
    assert np.max(np.abs(_np(g) - _np(w)) / _spacing(scale, "f32")) <= 4


# ---------------------------------------------------------------------------
# AirComp on stacked delta trees and the explicit channel


@pytest.mark.parametrize("sched,weighted", [(False, False), (True, True)])
def test_aircomp_aggregate_matches_reference(sched, weighted):
    """Same deltas and key: the norms and Δ_max within 1e-6 relative
    (float32 sums in another order), the noisy mean within 4 ulp of
    |mean| + 6σ (the per-leaf normals' ulps)."""
    rs = np.random.default_rng(1)
    M = 5
    deltas = jax.tree.map(lambda x: (0.01 * x).astype(np.float32),
                          {"w": rs.normal(size=(M, 24, 4)),
                           "b": rs.normal(size=(M, 4)),
                           "s": rs.normal(size=(M,))})
    mask = np.asarray([True, False, True, True, True]) if sched else None
    weights = rs.uniform(0.5, 1.5, M).astype(np.float32) if weighted \
        else None
    jagg, jst = jair.aircomp_aggregate(
        jax.tree.map(jnp.asarray, deltas), jax.random.key(6), snr_db=5.0,
        h_min=0.8, mask=None if mask is None else jnp.asarray(mask),
        weights=None if weights is None else jnp.asarray(weights))
    tagg, tst = tair.aircomp_aggregate(
        convert.to_torch(deltas), prng.key(6), snr_db=5.0, h_min=0.8,
        mask=None if mask is None else torch.from_numpy(mask),
        weights=None if weights is None else torch.from_numpy(weights))
    assert sorted(jst) == sorted(tst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-6)
    sigma = float(jst["aircomp_noise_std"])
    _assert_trees(tagg, jagg, lambda g, w: _within_terms(g, w, sigma))
    np.testing.assert_allclose(
        tair._delta_sq_norms(convert.to_torch(deltas)).numpy(),
        np.asarray(jair._delta_sq_norms(jax.tree.map(jnp.asarray, deltas))),
        rtol=1e-6)


@pytest.mark.parametrize("given_h", [False, True])
def test_aircomp_simulate_channel_matches_reference(given_h):
    """The channel and mask from the same key (the mask bitwise), the
    transmit energies and Δ_max within 1e-5 relative and the recovered
    update within 1e-5 of its scale: complex64 products and divisions in
    another order, amplified by the channel inversion α ∝ 1/h."""
    rs = np.random.default_rng(2)
    M, d = 6, 300
    deltas = (0.01 * rs.normal(size=(M, d))).astype(np.float32)
    h = (rs.normal(size=M) + 1j * rs.normal(size=M)).astype(np.complex64) \
        / np.float32(np.sqrt(2)) if given_h else None
    jy, jdiag = jair.aircomp_simulate_channel(
        jnp.asarray(deltas), jax.random.key(8), snr_db=10.0, h_min=0.5,
        h=None if h is None else jnp.asarray(h))
    ty, tdiag = tair.aircomp_simulate_channel(
        torch.from_numpy(deltas), prng.key(8), snr_db=10.0, h_min=0.5,
        h=None if h is None else torch.from_numpy(h))
    np.testing.assert_array_equal(np.asarray(jdiag["mask"]),
                                  tdiag["mask"].numpy())
    np.testing.assert_allclose(tdiag["h"].numpy(), np.asarray(jdiag["h"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("tx_energy", "delta_max", "m_effective"):
        np.testing.assert_allclose(np.asarray(tdiag[k]),
                                   np.asarray(jdiag[k]), rtol=1e-5)
    assert tdiag["energy_budget"] == jdiag["energy_budget"]
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())


# ---------------------------------------------------------------------------
# embedding lookup and checkpoints


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_lookup_is_jnp_take(dtype):
    """A negative id counts from the end; an id outside [-rows, rows) gives
    a NaN row, as ``jnp.take``'s default fill mode does."""
    rs = np.random.default_rng(0)
    table = rs.normal(size=(4, 3)).astype(np.float32)
    ids = np.asarray([[1, 5, -1], [0, -4, -5]], np.int32)
    want = jlayers.embed_fwd({"tok": jnp.asarray(table).astype(
        DT[dtype][0])}, jnp.asarray(ids))
    got = tlayers.embed_fwd({"tok": torch.from_numpy(table).to(
        DT[dtype][1])}, torch.from_numpy(ids))
    assert got.dtype == DT[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(want))
    assert np.isnan(_np(got)[0, 1]).all() and np.isnan(_np(got)[1, 2]).all()
    np.testing.assert_array_equal(_np(got)[0, 2], _np(want)[0, 2])


def test_checkpoints_interchange_with_the_reference(tmp_path):
    """Float32 trees saved by either package restore bitwise in the other,
    under the same npz keys; the sidecars carry the same config hash."""
    params = _tree(9)
    cfg = dict(lr=0.1, b2=4)
    jckpt.save(str(tmp_path / "j"), jax.tree.map(jnp.asarray, params),
               step=3, meta=JConfig(**cfg))
    tckpt.save(str(tmp_path / "t"), convert.to_torch(params), step=5,
               meta=TConfig(**cfg))
    assert sorted(np.load(tmp_path / "j" / "params.npz").files) == \
        sorted(np.load(tmp_path / "t" / "params.npz").files)
    got, step = tckpt.restore(str(tmp_path / "j"), convert.to_torch(
        _tree(10)))
    assert step == 3
    _assert_trees(got, params, lambda g, w: np.testing.assert_array_equal(
        _np(g), w))
    want, step = jckpt.restore(str(tmp_path / "t"),
                               jax.tree.map(jnp.asarray, _tree(10)))
    assert step == 5
    _assert_trees(convert.to_torch(jax.device_get(want)), params,
                  lambda g, w: np.testing.assert_array_equal(_np(g), w))
    import json
    metas = [json.load(open(tmp_path / k / "meta.json")) for k in "jt"]
    assert metas[0]["config_hash"] == metas[1]["config_hash"] \
        == tckpt.config_hash(TConfig(**cfg))
    assert "torch_version" in metas[1]


def test_checkpoint_bfloat16_round_trip_and_errors(tmp_path):
    """bfloat16 leaves go to disk as the 2-byte records jax's arrays make
    (``|V2``) and come back bitwise; a missing leaf or another shape
    raises, naming the leaf."""
    params = convert.to_torch(_tree(11))
    params["blocks"]["attn"]["wq"] = params["blocks"]["attn"]["wq"].to(
        torch.bfloat16)
    tckpt.save(str(tmp_path / "b"), params, step=1)
    raw = np.load(tmp_path / "b" / "params.npz")
    assert raw["['blocks']['attn']['wq']"].dtype == np.dtype("V2")
    jbf = np.asarray(jnp.asarray(_tree(11)["blocks"]["attn"]["wq"]).astype(
        jnp.bfloat16))
    assert raw["['blocks']['attn']['wq']"].tobytes() == jbf.tobytes()
    got, step = tckpt.restore(str(tmp_path / "b"),
                              ttree.tree_zeros_like(params))
    assert step == 1 and got["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    for (name, g), (_, w) in zip(sorted(_flat_items(got)),
                                 sorted(_flat_items(params))):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    other = ttree.tree_zeros_like(params)
    other["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="extra"):
        tckpt.restore(str(tmp_path / "b"), other)
    other = ttree.tree_zeros_like(params)
    other["final_norm"]["scale"] = torch.zeros(9)
    with pytest.raises(ValueError, match="final_norm"):
        tckpt.restore(str(tmp_path / "b"), other)
    assert os.path.exists(tmp_path / "b" / "meta.json")
