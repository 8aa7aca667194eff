"""Mixture-of-Experts with sort-based capacity dispatch, on one device.

Counterpart of ``repro/models/moe.py:40-210`` with ``mesh=None``:
``init_moe``, ``_capacity``, ``_route_and_compute`` and ``moe_fwd``. The
reference's expert-parallel ``shard_map`` branch (tokens over ``data``,
experts over ``model``) is not ported: ``moe_fwd`` given a mesh raises
``NotImplementedError``.

Routing is the reference's, integer for integer:

- the router matmul runs in the activation dtype and the softmax in
  float32; the top k experts of a token are taken by a stable descending
  sort, so among equal probabilities the lower expert index comes first,
  as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order on
  ties, and in bfloat16 a tie at the k-th place among 128 or 256 experts
  is not rare);
- the T·k assignments are stably sorted by local expert id (a
  non-local expert is the dustbin id ``e_local``); assignment p of expert
  e sits at slot ``p − starts[e]`` and is kept while that slot is below
  the capacity.

The reference moves tokens with two scatters: a dispatch that writes each
kept ``(expert, slot)`` once into a zeroed ``[E + 1, C, d]`` buffer, and a
combine that adds each assignment's gated expert output into its token's
row, chunk j = 0 … k − 1 of T sorted assignments at a time, in order. Here
both are gathers, with no scatter and no atomics, so a run on the card is
bitwise a second run of itself: slot (e, c) reads the token of sorted
assignment ``starts[e] + c`` (zero when c is past the expert's kept
count); token t adds its k contributions in ascending sorted position,
which is the reference's order of adds (chunk by chunk, in index order
within a chunk), one rounding in the activation dtype at a time.

The expert FFNs are batched GEMMs over ``[E, C, d] × [E, d, f]``: the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import _act, dense_init, init_mlp, mlp_fwd
from repro_torch.utils import prng


def init_moe(rng, cfg, dtype, *, device="cpu"):
    """Router (float32 among the model's leaves), expert weights ``[E, d,
    f]``/``[E, f, d]`` and, with shared experts, one MLP of width ``f ·
    n_shared_experts``, from ``split(rng, 5)`` as the reference draws them.
    Each expert leaf is drawn in chunks into its one output tensor."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    ks = prng.split(rng, 5)

    def ew(k, shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=device)
        # a true division, as the reference's (a Python scalar divisor is a
        # reciprocal multiply on the card)
        return prng.normal_into(
            k, out, lambda g: g / torch.full_like(g, fan_in ** 0.5))

    p = {"router": dense_init(ks[0], d, E, torch.float32, device=device),
         "w_gate": ew(ks[1], (E, d, f), d),
         "w_up": ew(ks[2], (E, d, f), d),
         "w_down": ew(ks[3], (E, f, d), f)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(ks[4], d, f * cfg.n_shared_experts, cfg.act,
                               dtype, device=device)
    return p


def _capacity(n_tokens, cfg, e_local):
    per_expert = n_tokens * cfg.top_k / cfg.n_experts
    c = int(per_expert * cfg.capacity_factor) + 1
    return max(c, cfg.top_k)  # floor so tiny smoke shapes don't drop everything


def route(x_flat, p_router, *, cfg, e_offset, e_local, capacity):
    """The routing of tokens ``x_flat [T, d]`` over local experts
    ``[e_offset, e_offset + e_local)``: a dict of

    - ``probs [T, E]`` (float32), ``idx [T, k]`` (each token's top-k
      experts, best first), ``fe [T·k]`` (``idx`` flat), ``order`` (the
      stable sort of the assignments by local expert id);
    - over the T·k assignments in sorted order: ``se`` (local expert id,
      ``e_local`` for the dustbin), ``st`` (token), ``sg`` (gate), ``pos``
      (slot within the expert), ``keep``;
    - ``starts``, ``counts`` ``[e_local + 1]`` (each local expert's first
      sorted position and assignment count).
    """
    T = x_flat.shape[0]
    k = cfg.top_k
    dev = x_flat.device
    # the router matmul in the activation dtype, the softmax in float32
    logits = (x_flat @ p_router.to(x_flat.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :k], top.indices[:, :k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    fe = idx.reshape(-1)                                    # [T*k]
    ft = torch.arange(T, device=dev).repeat_interleave(k)   # token of each
    fg = gates.reshape(-1)
    is_local = (fe >= e_offset) & (fe < e_offset + e_local)
    le = torch.where(is_local, fe - e_offset, e_local)
    order = torch.argsort(le, stable=True)
    se, st, sg = le[order], ft[order], fg[order]
    counts = torch.bincount(se, minlength=e_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[se]
    keep = (se < e_local) & (pos < capacity)
    return dict(probs=probs, idx=idx, fe=fe, order=order, se=se, st=st,
                sg=sg, pos=pos, keep=keep, starts=starts, counts=counts)


def _route_and_compute(x_flat, p_router, w_gate, w_up, w_down, *, cfg,
                       e_offset, e_local, capacity):
    """Dispatch tokens in x_flat [T, d] to local experts [e_offset,
    e_offset + e_local). Returns (partial_out [T, d], (me, ce) partial
    load-balance stats)."""
    T, d = x_flat.shape
    k = cfg.top_k
    dev = x_flat.device
    r = route(x_flat, p_router, cfg=cfg, e_offset=e_offset, e_local=e_local,
              capacity=capacity)
    se, st, keep = r["se"], r["st"], r["keep"]

    # dispatch: slot (e, c) holds sorted assignment starts[e] + c while c
    # is below the expert's kept count, else zeros
    slot = torch.arange(capacity, device=dev)
    kept = r["counts"][:e_local].clamp(max=capacity)
    filled = slot[None, :] < kept[:, None]                  # [E_l, C]
    src = torch.where(filled, r["starts"][:e_local, None] + slot[None, :], 0)
    h_in = torch.where(filled[..., None], x_flat[st[src]], 0.0)

    if cfg.act in ("swiglu", "geglu"):
        h = _act(torch.bmm(h_in, w_gate), cfg.act) * torch.bmm(h_in, w_up)
    else:
        h = _act(torch.bmm(h_in, w_up), cfg.act)
    out_buf = torch.bmm(h, w_down)                          # [E_l, C, d]
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, capacity, d))], 0)

    # combine: token t adds its k gated contributions in ascending sorted
    # position (the reference's chunk-by-chunk, in-order scatter-add)
    se_c = torch.where(keep, se, e_local)
    pos_c = torch.where(keep, r["pos"], 0)
    w = torch.where(keep, r["sg"], 0.0).to(x_flat.dtype)
    inv = torch.empty_like(r["order"])
    inv[r["order"]] = torch.arange(T * k, device=dev)
    by_token = torch.sort(inv.reshape(T, k), dim=1).values  # [T, k]
    out = torch.zeros((T, d), dtype=x_flat.dtype, device=dev)
    for j in range(k):
        q = by_token[:, j]
        out = out + out_buf[se_c[q], pos_c[q]] * w[q][:, None]

    # Switch-style load-balance stats (partial; the caller normalizes);
    # ce counts every routed assignment, dropped ones included
    me = torch.sum(r["probs"], dim=0)                       # [E]
    ce = torch.bincount(r["fe"], minlength=cfg.n_experts).to(torch.float32)
    return out, (me, ce)


def moe_fwd(p, cfg, x, mesh=None):
    """x [B, S, d] -> (out [B, S, d], aux_loss scalar float32)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_fwd over a mesh (the reference's expert-parallel shard_map) "
            "is not ported; call it with mesh=None")
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    E = cfg.n_experts
    cap = _capacity(B * S, cfg, E)
    out, (me, ce) = _route_and_compute(
        x_flat, p["router"], p["w_gate"], p["w_up"], p["w_down"],
        cfg=cfg, e_offset=0, e_local=E, capacity=cap)
    n_tok = B * S
    # true divisions, as the reference's (full_like: no host copy)
    me = me / torch.full_like(me, n_tok)
    ce = ce / torch.full_like(ce, n_tok * cfg.top_k)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_fwd(p["shared"], x, cfg.act)
    return out, aux
