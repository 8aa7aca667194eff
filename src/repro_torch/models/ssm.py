"""SSM layers: the RWKV-6 time and channel mix and a selective
(Mamba-style) diagonal SSM, in PyTorch.

Counterpart of ``repro/models/ssm.py:25-252``, plain torch (the reference
is plain jnp: no Pallas kernel rides on these layers), in float32 where
the reference is.

RWKV-6 WKV (data-dependent per-channel decay, a matrix state per head):
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
in the reference's chunked parallel form: within a chunk of C = 16 tokens
the pairwise factor exp(l_{t-1} − l_j) (l the running log-decay, each step
clamped to [−DECAY_CLAMP, −1e−6]) stays within float32 range. The
reference chains the chunks with a ``lax.scan`` whose body also computes
every chunk-local term; here those terms (which do not read the state) are
computed for all chunks at once, and the Python loop over chunks carries
only the state update ``S ← exp(l_tot)·S + K_decᵀV``, each element's
arithmetic the reference's. Decode is the one-step recurrence on the
cached ``[B, H, hd, hd]`` state.

The selective SSM keeps a diagonal state ``[B, d, n]``: within chunks of
SSM_CHUNK = 256 tokens the reference runs ``jax.lax.associative_scan``,
whose recursion (pairs of neighbours combined, the halves scanned, the
evens fixed up) ``associative_scan`` below repeats step for step, so the
order of products is the reference's; the chunks are then chained by the
state, again a loop of one multiply-add per chunk.

The ``*_batched`` forms run one layer per client of a cohort (the flat
round's ``[M, ...]`` leaves, views into the cohort buffer, and x ``[M, B,
T, d]``), the reference's layer under ``jax.vmap``: the projections are
batched GEMMs, each client's elementwise leaves broadcast over its own
rows, and the WKV chunk loop and the selective scan run once over all M·B
rows, so the Python loops do not grow with M. Each product keeps the
one-client order: on the CPU a client's rows are bitwise its own layer's
where its tensors fill whole vector groups of PyTorch's elementwise
kernels, and otherwise an exp or log can take the vectorized path in one
and the scalar tail in the other (an ulp).

``ln_x`` normalises over all of d (``norm_fwd(..., "layernorm")`` on
``[B, T, d]``), as the reference's code does. ``jax.nn.softplus`` is
``logaddexp(x, 0)``, and so is ``_softplus``. The leaves ``w0``, ``u``,
``a_log``, ``dt_bias`` and ``d_skip`` are float32 among the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, init_norm, norm_fwd,
                                       norm_fwd_batched)
from repro_torch.utils import prng
from repro_torch.utils.shardutil import (as_dtensor, is_dtensor, merge_last,
                                         reduced, split_last)

WKV_CHUNK = 16
DECAY_CLAMP = 4.0
SSM_CHUNK = 256

_F32 = torch.float32


# ---------------------------------------------------------------------------
# RWKV-6


def init_rwkv_tmix(rng, cfg, dtype, *, device="cpu"):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    ks = prng.split(rng, 10)
    lora = 64 if d >= 512 else 16

    def w(i, d_in, d_out, scale=None):
        return dense_init(ks[i], d_in, d_out, dtype, scale, device=device)

    return {
        "mu": torch.full((5, d), 0.5, dtype=dtype, device=device),
        "w0": torch.zeros((d,), dtype=_F32, device=device),  # decay bias
        "w_lora_a": w(0, d, lora, 0.01),
        "w_lora_b": w(1, lora, d, 0.01),
        "wr": w(2, d, d),
        "wk": w(3, d, d),
        "wv": w(4, d, d),
        "wg": w(5, d, d),
        "wo": w(6, d, d),
        "u": torch.zeros((H, hd), dtype=_F32, device=device),  # head bonus
        "ln_x": init_norm(d, "layernorm", dtype, device=device),
    }


def _tmix_project(p, cfg, x, x_prev):
    """Token-shift lerp and projections. x, x_prev ``[B, T, d]`` -> (r, k,
    v ``[B, T, H, hd]``, g ``[B, T, d]``, logw ``[B, T, H, hd]`` float32)."""
    delta = x_prev - x
    xr, xk, xv, xg, xw = (x + delta * p["mu"][i] for i in range(5))
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    r = split_last(xr @ p["wr"], (B, T, H, hd))
    k = split_last(xk @ p["wk"], (B, T, H, hd))
    v = split_last(xv @ p["wv"], (B, T, H, hd))
    g = F.silu(xg @ p["wg"])
    # the data-dependent decay (the RWKV-6 signature feature)
    w_raw = p["w0"] + (torch.tanh(xw @ p["w_lora_a"])
                       @ p["w_lora_b"]).to(_F32)
    logw = torch.clamp(-torch.exp(w_raw), -DECAY_CLAMP, -1e-6)
    return r, k, v, g, split_last(logw, (B, T, H, hd))


def _scan_shards(scan, seqs, s0, per_head=()):
    """``scan(*seqs, *per_head, s0)`` of DTensors on each rank's batch rows
    and dim-2 block (heads or channels: the WKV and selective scans mix
    neither): seqs ``[B, T, H, ...]`` laid out over dims 0 and 2 only,
    each of ``per_head`` (``[H, ...]``) and the entry state s0 (``[B, H,
    ...]``) cut to the local rows and block; the outputs, a sequence of
    seqs' shape and the final state, DTensors of that layout. A plain or
    replicated state would gather every row and block instead.

    A mesh axis on which the sequences are partial sums (a projection
    contracted over a sharded d) splits dim 2 where it divides: a
    reduce-scatter onto the heads or channels, as GSPMD lays out the
    reference's scan, where an all-reduce would run every head or channel
    on every rank of that axis. A replicated axis stays replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, shape = seqs[0].device_mesh, tuple(seqs[0].shape)
    n2 = 1
    for i, p in enumerate(seqs[0].placements):
        if p.is_shard(2):
            n2 *= mesh.size(i)
    want = []
    for i, p in enumerate(seqs[0].placements):
        if p.is_shard(0) or p.is_shard(2):
            want.append(p)
        elif p.is_partial() and shape[2] % (n2 * mesh.size(i)) == 0:
            want.append(Shard(2))
            n2 *= mesh.size(i)
        else:
            want.append(Replicate())
    seqs = [t if tuple(t.placements) == tuple(want)
            else t.redistribute(t.device_mesh, want) for t in seqs]
    ls, off = compute_local_shape_and_global_offset(shape, mesh, want)
    rows, heads = slice(off[0], off[0] + ls[0]), slice(off[2],
                                                       off[2] + ls[2])

    # each rank reads its block of the whole per-head leaves and entry
    # state, so their gradient is a partial sum over the axes that split
    # the rows or the heads (and whole over the others)
    grads = [Partial() if p.is_shard() else Replicate() for p in want]

    def whole(t):
        if not is_dtensor(t):
            return t
        t = t.redistribute(mesh, [Replicate()] * len(want)).to_local(
            grad_placements=grads)
        return t.wait() if hasattr(t, "wait") else t
    out, s = scan(*(t.to_local() for t in seqs),
                  *(whole(t)[heads] for t in per_head),
                  whole(s0)[rows, heads])
    s_want = [Shard(1) if p.is_shard(2) else p for p in want]
    return (as_dtensor(out, mesh, want, shape),
            as_dtensor(s, mesh, s_want, (shape[0], shape[2])
                       + tuple(s.shape[2:])))


def wkv_chunked(r, k, v, logw, u, s0):
    """Chunked WKV. r/k/v/logw ``[B, T, H, hd]``; u ``[H, hd]``, or ``[B,
    H, hd]`` (a bonus per row: the cohort's rows); s0 ``[B, H, hd, hd]``.
    Returns (out ``[B, T, H, hd]`` float32, s_final). DTensors run on each
    rank's rows and heads (``_scan_shards``)."""
    if is_dtensor(r):
        return _scan_shards(wkv_chunked, (r, k, v, logw), s0, per_head=(u,))
    B, T, H, hd = r.shape
    C = min(WKV_CHUNK, T)
    pad = (-T) % C
    if pad:  # identity pad: w = 1 (logw 0), k = 0: the state passes through
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    n = (T + pad) // C

    def chunks(x):                                  # -> [n, B, H, C, hd]
        return x.to(_F32).reshape(B, n, C, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lc = chunks(r), chunks(k), chunks(v), chunks(logw)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    l_inc = torch.cumsum(lc, dim=3)             # inclusive running log decay
    l_exc = l_inc - lc                          # exclusive (l_{t-1})
    r_dec = rc * torch.exp(l_exc)               # decay factors <= 1
    k_grow = kc * torch.exp(-l_inc)             # bounded by C·CLAMP in exp
    A = torch.einsum("nbhtd,nbhjd->nbhtj", r_dec, k_grow)
    A = torch.where(tri, A, 0.0)
    intra = torch.einsum("nbhtj,nbhjv->nbhtv", A, vc)
    diag = torch.einsum("nbhtd,nbhtd->nbht", rc, kc * u[..., None, :])
    l_tot = l_inc[:, :, :, -1:, :]              # [n, B, H, 1, hd]
    kv = torch.einsum("nbhjd,nbhjv->nbhdv", kc * torch.exp(l_tot - l_inc),
                      vc)
    decay = torch.exp(l_tot[:, :, :, 0])[..., None]
    s, states = s0.to(_F32), []
    for c in range(n):                          # the state entering chunk c
        states.append(s)
        s = decay[c] * s + kv[c]
    carry = torch.einsum("nbhtd,nbhdv->nbhtv", r_dec, torch.stack(states))
    out = intra + carry                         # the carry-in
    out = out + diag[..., None] * vc            # the bonus term
    out = out.permute(1, 0, 3, 2, 4).reshape(B, n * C, H, hd)[:, :T]
    return out, s


def wkv_step(r, k, v, logw, u, s):
    """One decode step. r/k/v/logw ``[B, H, hd]``; s ``[B, H, hd, hd]``.
    DTensors take the same sums as broadcast products and a reduction
    (the einsums' reshapes would flatten sharded heads)."""
    if is_dtensor(r):
        kv = k.to(_F32)[..., :, None] * v.to(_F32)[..., None, :]
        out = torch.sum(r.to(_F32)[..., None]
                        * (s + u[None, ..., None] * kv), dim=-2)
    else:
        kv = torch.einsum("bhd,bhv->bhdv", k.to(_F32), v.to(_F32))
        out = torch.einsum("bhd,bhdv->bhv", r.to(_F32),
                           s + u[None, ..., None] * kv)
    s_new = torch.exp(logw.to(_F32))[..., None] * s + kv
    return out, s_new


def rwkv_tmix_fwd(p, cfg, x, *, state=None, x_prev_last=None):
    """Full-sequence time mix. Returns (out, (s_final, last x))."""
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    prev0 = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device) \
        if x_prev_last is None else x_prev_last[:, None, :]
    x_prev = torch.cat([prev0, x[:, :-1]], dim=1)
    r, k, v, g, logw = _tmix_project(p, cfg, x, x_prev)
    s0 = torch.zeros((B, H, hd, hd), dtype=_F32, device=x.device) \
        if state is None else state
    out, s_fin = wkv_chunked(r, k, v, logw, p["u"], s0)
    out = norm_fwd(p["ln_x"], merge_last(out).to(x.dtype), "layernorm")
    return (out * g) @ p["wo"], (s_fin, x[:, -1])


def rwkv_tmix_step(p, cfg, x, state, x_prev):
    """Decode step. x ``[B, 1, d]``; state ``[B, H, hd, hd]``; x_prev ``[B,
    d]``."""
    B, _, d = x.shape
    r, k, v, g, logw = _tmix_project(p, cfg, x, x_prev[:, None])
    out, s_new = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["u"],
                          state)
    out = norm_fwd(p["ln_x"], out.reshape(B, 1, d).to(x.dtype), "layernorm")
    return (out * g) @ p["wo"], (s_new, x[:, 0])


def init_rwkv_cmix(rng, cfg, dtype, *, device="cpu"):
    d = cfg.d_model
    ks = prng.split(rng, 3)
    return {"mu_k": torch.full((d,), 0.5, dtype=dtype, device=device),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=device),
            "wk": dense_init(ks[0], d, cfg.d_ff, dtype, device=device),
            "wv": dense_init(ks[1], cfg.d_ff, d, dtype, device=device),
            "wr": dense_init(ks[2], d, d, dtype, device=device)}


def rwkv_cmix_fwd(p, x, x_prev):
    """Channel mix with token shift. x, x_prev ``[B, T, d]``."""
    delta = x_prev - x
    xk = x + delta * p["mu_k"]
    xr = x + delta * p["mu_r"]
    h = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (h @ p["wv"])


# ---------------------------------------------------------------------------
# client-batched forms (the flat round's cohort)


def _bmm(x, w):
    """x ``[M, ..., d_in]`` against client m's weight ``w[m]`` ``[d_in,
    d_out]``: one batched GEMM over ``[M, T, d_in]`` rows."""
    M = x.shape[0]
    out = x.reshape(M, -1, x.shape[-1]) @ w
    return out.reshape(x.shape[:-1] + out.shape[-1:])


def _per_client(leaf, x):
    """A ``[M, *s]`` leaf broadcast over x ``[M, ..., *s]``: client m's
    elementwise leaf over its own rows."""
    lead = x.dim() - leaf.dim()
    return leaf.reshape(leaf.shape[:1] + (1,) * lead + leaf.shape[1:])


def _rows(leaf, b):
    """``[M, ...]`` -> ``[M·b, ...]``: client m's leaf for each of its b
    batch rows (the rows the chunk loops run over)."""
    return leaf.repeat_interleave(b, 0)


def rwkv_tmix_fwd_batched(p, cfg, x):
    """``rwkv_tmix_fwd`` per client from a zero state and a zero token
    shift: x ``[M, B, T, d]``, leaves ``[M, ...]`` -> ``[M, B, T, d]``. The
    projections are batched GEMMs; the chunked WKV runs once over the
    ``[M·B]`` rows, each with its client's bonus ``u``."""
    M, B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    x_prev = torch.cat([x.new_zeros((M, B, 1, d)), x[:, :, :-1]], dim=2)
    delta = x_prev - x
    mu = p["mu"]
    xr, xk, xv, xg, xw = (x + delta * _per_client(mu[:, i], x)
                          for i in range(5))
    r, k, v = (_bmm(a, p[w]).reshape(M * B, T, H, hd)
               for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(_bmm(xg, p["wg"]))
    lora = _bmm(torch.tanh(_bmm(xw, p["w_lora_a"])), p["w_lora_b"])
    w_raw = _per_client(p["w0"], x) + lora.to(_F32)
    logw = torch.clamp(-torch.exp(w_raw), -DECAY_CLAMP, -1e-6)
    s0 = torch.zeros((M * B, H, hd, hd), dtype=_F32, device=x.device)
    out, _ = wkv_chunked(r, k, v, logw.reshape(M * B, T, H, hd),
                         _rows(p["u"], B), s0)
    out = norm_fwd_batched(p["ln_x"], out.reshape(M, B, T, d).to(x.dtype),
                           "layernorm")
    return _bmm(out * g, p["wo"])


def rwkv_cmix_fwd_batched(p, x, x_prev):
    """``rwkv_cmix_fwd`` per client: x, x_prev ``[M, B, T, d]``."""
    delta = x_prev - x
    xk = x + delta * _per_client(p["mu_k"], x)
    xr = x + delta * _per_client(p["mu_r"], x)
    h = torch.square(F.relu(_bmm(xk, p["wk"])))
    return torch.sigmoid(_bmm(xr, p["wr"])) * _bmm(h, p["wv"])


# ---------------------------------------------------------------------------
# Selective (Mamba-style) diagonal SSM: the Hymba hybrid's second branch


def init_mamba(rng, cfg, dtype, *, device="cpu"):
    d, n = cfg.d_model, cfg.ssm_state
    ks = prng.split(rng, 6)
    return {
        "w_in": dense_init(ks[0], d, 2 * d, dtype, device=device),  # x, z
        "w_bcdt": dense_init(ks[1], d, 2 * n + 1, dtype, device=device),
        "a_log": torch.zeros((d, n), dtype=_F32, device=device),
        "dt_bias": torch.zeros((d,), dtype=_F32, device=device),
        "d_skip": torch.ones((d,), dtype=_F32, device=device),
        "w_out": dense_init(ks[2], d, d, dtype, device=device),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _mamba_abc(p, xz):
    """The decay a and input b ``[B, T, d, n]`` (float32) and C ``[B, T,
    n]`` of the ``x`` branch xz ``[B, T, d]``."""
    n = p["a_log"].shape[1]
    bcdt = reduced(xz @ p["w_bcdt"])    # (sliced next: whole sums)
    Bm, Cm, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n]
    dt = _softplus(dt.to(_F32) + reduced(p["dt_bias"].mean()))[..., None]
    A = -torch.exp(p["a_log"])                              # [d, n], < 0
    a = torch.exp(dt[..., None] * A)                        # [B, T, d, n]
    b = (dt * Bm.to(_F32))[:, :, None, :] * xz.to(_F32)[..., None]
    return a, b, Cm


def _take(x, dim, start, stop=None, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a, b, dim):
    """a at the even and b at the odd positions of ``dim``."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    _take(out, dim, 0, None, 2).copy_(a)
    _take(out, dim, 1, None, 2).copy_(b)
    return out


def associative_scan(fn, elems, dim):
    """``jax.lax.associative_scan(fn, elems, axis=dim)`` (forward) on a
    tuple of tensors, by jax's recursion: combine neighbouring pairs, scan
    the half-length result, combine each odd prefix with the next even
    element, interleave. ``fn(earlier, later)`` takes and returns tuples."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                 tuple(_take(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(_take(e, dim, 0, -1) for e in odd),
                  tuple(_take(e, dim, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(_take(e, dim, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_take(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return a2 * a1, a2 * b1 + b2


def diag_ssm_scan(a, b, s0, chunk=SSM_CHUNK):
    """h_t = a_t ⊙ h_{t-1} + b_t over T; a, b ``[B, T, d, n]``; s0 ``[B, d,
    n]``. Within each chunk the associative scan (all chunks at once), then
    the chunks chained by the state. Returns (h ``[B, T, d, n]``,
    s_final). DTensors run on each rank's rows and channels
    (``_scan_shards``)."""
    if is_dtensor(a):
        return _scan_shards(
            lambda a_, b_, s_: diag_ssm_scan(a_, b_, s_, chunk), (a, b), s0)
    B, T, d, n = a.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:  # identity elements: a = 1, b = 0
        a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
    nc = (T + pad) // C
    aa, bb = associative_scan(_combine, (a.reshape(B, nc, C, d, n),
                                         b.reshape(B, nc, C, d, n)), 2)
    s, states = s0, []
    for c in range(nc):                         # the state entering chunk c
        states.append(s)
        s = aa[:, c, -1] * s + bb[:, c, -1]
    h = aa * torch.stack(states, 1)[:, :, None] + bb
    return h.reshape(B, nc * C, d, n)[:, :T], s


def mamba_fwd(p, cfg, x, *, state=None):
    """Full-sequence selective SSM. x ``[B, T, d]`` -> (out, s_final)."""
    B, T, d = x.shape
    xz = x @ p["w_in"]
    xs, z = F.silu(xz[..., :d]), xz[..., d:]
    a, b, Cm = _mamba_abc(p, xs)
    s0 = torch.zeros((B, d, cfg.ssm_state), dtype=_F32, device=x.device) \
        if state is None else state
    h, s_fin = diag_ssm_scan(a, b, s0)
    y = torch.einsum("btdn,btn->btd", h, Cm.to(_F32))
    y = y + p["d_skip"] * xs.to(_F32)
    return (y.to(x.dtype) * F.silu(z)) @ p["w_out"], s_fin


def mamba_step(p, cfg, x, state):
    """One decode step. x ``[B, 1, d]``; state ``[B, d, n]``."""
    d = x.shape[2]
    xz = x @ p["w_in"]
    xs, z = F.silu(xz[..., :d]), xz[..., d:]
    a, b, Cm = _mamba_abc(p, xs)
    s_new = a[:, 0] * state + b[:, 0]
    y = torch.einsum("bdn,bn->bd", s_new, Cm[:, 0].to(_F32))
    y = y + p["d_skip"] * xs[:, 0].to(_F32)
    return (y[:, None].to(x.dtype) * F.silu(z)) @ p["w_out"], s_new


def mamba_fwd_batched(p, cfg, x):
    """``mamba_fwd`` per client from a zero state: x ``[M, B, T, d]``,
    leaves ``[M, ...]`` -> ``[M, B, T, d]``. The projections are batched
    GEMMs, ``a_log``, ``dt_bias`` and ``d_skip`` each client's own over
    its rows, and the selective scan runs once over the ``[M·B]`` rows."""
    M, B, T, d = x.shape
    n = cfg.ssm_state
    xz = _bmm(x, p["w_in"])
    xs, z = F.silu(xz[..., :d]), xz[..., d:]
    bcdt = _bmm(xs, p["w_bcdt"])
    Bm, Cm, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n]
    bias = p["dt_bias"].mean(dim=-1).reshape(M, 1, 1)
    dt = _softplus(dt.to(_F32) + bias)[..., None]           # [M, B, T, 1]
    A = -torch.exp(p["a_log"])                              # [M, d, n]
    a = torch.exp(dt[..., None] * A.reshape(M, 1, 1, d, n))  # [M, B, T, d, n]
    b = (dt * Bm.to(_F32))[..., None, :] * xs.to(_F32)[..., None]
    s0 = torch.zeros((M * B, d, n), dtype=_F32, device=x.device)
    h, _ = diag_ssm_scan(a.reshape(M * B, T, d, n),
                         b.reshape(M * B, T, d, n), s0)
    y = torch.einsum("btdn,btn->btd", h, Cm.reshape(M * B, T, n).to(_F32))
    y = y.reshape(M, B, T, d) + _per_client(p["d_skip"], x) * xs.to(_F32)
    return _bmm(y.to(x.dtype) * F.silu(z), p["w_out"])
