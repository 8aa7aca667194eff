"""Mixture-of-Experts with sort-based capacity dispatch and expert
parallelism.

Counterpart of ``repro/models/moe.py``: ``init_moe``, ``_capacity``,
``_route_and_compute`` and ``moe_fwd``; and ``moe_fwd_batched``, the
reference's ``moe_fwd`` under ``jax.vmap`` over the clients of a flat or
wide round (each client routing its own tokens with its own router).

``moe_fwd`` given a mesh with a ``model`` axis is the reference's
expert-parallel ``shard_map``: its inputs and outputs are DTensors on the
mesh (``launch/sharding.py``) and its body works on each rank's local
tensors with functional collectives on the mesh's sub-groups, as
``local_map`` would. Experts are split over ``model``, each rank routing
its tokens to the ``e_local = E / n_model`` experts it owns (``e_offset =
model rank · e_local``; the others are the dustbin) and the partial
outputs summed over ``model``:

- train and prefill layout, when the B·S tokens divide over the data axes
  (and there is more than one data rank): tokens over the data axes, the
  expert FFN dim FSDP over the last data axis and all-gathered over it
  just in time, the capacity of the shard's token count, and the
  load-balance stats ``me`` and ``ce`` summed over the data axes;
- decode layout otherwise: tokens replicated, only the output summed.

Capacity counts the shard's tokens (``_capacity(T / n_data, …)``), so a
sharded and an unsharded forward agree only where nothing is dropped
(capacity factor E/k); at 1.25 they differ, in the same way in both
packages. ``mesh=None`` is the one-device path.

The expert-parallel forward is differentiable (a FedAvg step on the
mesh): its collectives are ``autograd.Function``s with the transposes of
jax's autodiff of the ``shard_map`` (``_moe_mesh``), on the functional
collectives that ``launch/mesh.bridge_gloo_cuda`` serves on a gloo mesh on
the card.

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

The cohort form (``route_batched``, ``moe_fwd_batched``) numbers client
m's expert e as the global expert ``m·E + e``: one stable sort of the
whole cohort's assignments then gives every client its own slots, drops
and order of adds, so row m of the cohort is client m's ``moe_fwd`` up to
the GEMMs' summation order.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (_act, dense_init, init_mlp, mlp_fwd,
                                       mlp_fwd_batched)
from repro_torch.utils import prng
from repro_torch.utils.shardutil import (P, constrain, dp_axes, is_dtensor,
                                         placements)


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


def _count(ids, n):
    """``torch.bincount(ids, minlength=n)`` for ids in ``[0, n)``: a
    scatter-add of ones, whose length is known without reading the ids
    (so it runs on ``meta`` shards in the dry-run); the same integers."""
    out = torch.zeros(n, dtype=torch.int64, device=ids.device)
    return out.scatter_add_(0, ids, torch.ones_like(ids))


def _sort_assignments(fe, ft, fg, n_exp, capacity):
    """Sort the assignments (expert id ``fe``, token ``ft``, gate ``fg``,
    each ``[A]``; ``n_exp`` is the dustbin id) stably by expert: ``order``,
    ``se``, ``st``, ``sg``, each expert's slot ``pos`` and ``keep`` in
    sorted order, and ``starts``, ``counts`` ``[n_exp + 1]``."""
    order = torch.argsort(fe, stable=True)
    se, st, sg = fe[order], ft[order], fg[order]
    counts = _count(se, n_exp + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(fe.shape[0], device=fe.device) - starts[se]
    keep = (se < n_exp) & (pos < capacity)
    return dict(order=order, se=se, st=st, sg=sg, pos=pos, keep=keep,
                starts=starts, counts=counts)


def _top_k(logits, k):
    """(probs, gates, idx) of float32 router ``logits [..., E]``: the
    softmax, each token's top k by a stable descending sort (jax's order
    among ties) and their gates renormalised to sum to 1."""
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]
    return probs, gates / torch.sum(gates, dim=-1, keepdim=True), idx


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
    # the router matmul in the activation dtype, the softmax in float32
    logits = (x_flat @ p_router.to(x_flat.dtype)).to(torch.float32)
    probs, gates, idx = _top_k(logits, k)
    fe = idx.reshape(-1)                                    # [T*k]
    ft = torch.arange(T, device=x_flat.device).repeat_interleave(k)
    is_local = (fe >= e_offset) & (fe < e_offset + e_local)
    le = torch.where(is_local, fe - e_offset, e_local)
    r = _sort_assignments(le, ft, gates.reshape(-1), e_local, capacity)
    return dict(probs=probs, idx=idx, fe=fe, **r)


def route_batched(x, p_router, *, cfg, capacity):
    """``route`` per client of a cohort, every expert local: tokens ``x
    [M, T, d]`` against routers ``[M, d, E]`` (one batched product). Client
    m's expert e is the global expert ``m·E + e`` (the dustbin ``M·E``
    takes nothing), and token t of client m the global row ``m·T + t``, so
    ONE stable sort of the ``M·T·k`` assignments puts client m's in a
    block of its own, in the order of client m's own sort: the slots,
    ``keep`` and the capacity per client are ``route``'s. ``probs [M, T,
    E]``, ``idx [M, T, k]`` and ``fe`` (global ids) as ``route``'s; the
    sorted fields over all M·T·k assignments."""
    M, T, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = (x @ p_router.to(x.dtype)).to(torch.float32)   # [M, T, E]
    probs, gates, idx = _top_k(logits, k)
    base = torch.arange(M, device=x.device) * E
    fe = (idx + base[:, None, None]).reshape(-1)            # [M*T*k]
    ft = torch.arange(M * T, device=x.device).repeat_interleave(k)
    r = _sort_assignments(fe, ft, gates.reshape(-1), M * E, capacity)
    return dict(probs=probs, idx=idx, fe=fe, **r)


def _dispatch(x_flat, r, n_exp, capacity):
    """``[n_exp, C, d]``: slot (e, c) holds the token of sorted assignment
    ``starts[e] + c`` while c is below the expert's kept count, else
    zeros."""
    slot = torch.arange(capacity, device=x_flat.device)
    kept = r["counts"][:n_exp].clamp(max=capacity)
    filled = slot[None, :] < kept[:, None]                  # [n_exp, C]
    src = torch.where(filled, r["starts"][:n_exp, None] + slot[None, :], 0)
    return torch.where(filled[..., None], x_flat[r["st"][src]], 0.0)


def _experts(h_in, w_gate, w_up, w_down, act):
    """The expert FFNs as batched GEMMs: ``[E, C, d] x [E, d, f]``."""
    if act in ("swiglu", "geglu"):
        h = _act(torch.bmm(h_in, w_gate), act) * torch.bmm(h_in, w_up)
    else:
        h = _act(torch.bmm(h_in, w_up), act)
    return torch.bmm(h, w_down)                             # [E, C, d]


def _combine(out_buf, r, n_tok, k, n_exp, dtype):
    """Each token adds its k gated expert outputs in ascending sorted
    position (the reference's chunk-by-chunk, in-order scatter-add), a
    dropped assignment reading the zero dustbin row."""
    C, d = out_buf.shape[1:]
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, C, d))], 0)
    keep = r["keep"]
    se_c = torch.where(keep, r["se"], n_exp)
    pos_c = torch.where(keep, r["pos"], 0)
    w = torch.where(keep, r["sg"], 0.0).to(dtype)
    order = r["order"]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    by_token = torch.sort(inv.reshape(n_tok, k), dim=1).values  # [T, k]
    out = torch.zeros((n_tok, d), dtype=dtype, device=out_buf.device)
    for j in range(k):
        q = by_token[:, j]
        out = out + out_buf[se_c[q], pos_c[q]] * w[q][:, None]
    return out


def _route_and_compute(x_flat, p_router, w_gate, w_up, w_down, *, cfg,
                       e_offset, e_local, capacity):
    """Dispatch tokens in x_flat [T, d] to local experts [e_offset,
    e_offset + e_local). Returns (partial_out [T, d], (me, ce) partial
    load-balance stats)."""
    r = route(x_flat, p_router, cfg=cfg, e_offset=e_offset, e_local=e_local,
              capacity=capacity)
    h_in = _dispatch(x_flat, r, e_local, capacity)
    out_buf = _experts(h_in, w_gate, w_up, w_down, cfg.act)
    out = _combine(out_buf, r, x_flat.shape[0], cfg.top_k, e_local,
                   x_flat.dtype)
    # Switch-style load-balance stats (partial; the caller normalizes);
    # ce counts every routed assignment, dropped ones included
    me = torch.sum(r["probs"], dim=0)                       # [E]
    ce = _count(r["fe"], cfg.n_experts).to(torch.float32)
    return out, (me, ce)


def _aux(me, ce, cfg, n_tok):
    """The load-balance loss from the summed stats (``[..., E]``): true
    divisions, as the reference's (full_like: no host copy)."""
    me = me / torch.full_like(me, n_tok)
    ce = ce / torch.full_like(ce, n_tok * cfg.top_k)
    return cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce, dim=-1)


def moe_fwd(p, cfg, x, mesh=None, data_axes=None, model_axis="model"):
    """x [B, S, d] -> (out [B, S, d], aux_loss scalar float32). With a
    ``mesh``: the expert-parallel forward (x and the leaves DTensors on
    it, or plain tensors on a one-member mesh)."""
    B, S, d = x.shape
    E = cfg.n_experts
    if mesh is not None:
        out, me, ce = _moe_mesh(p, cfg, x.reshape(B * S, d), mesh,
                                dp_axes(mesh) if data_axes is None
                                else tuple(data_axes), model_axis)
    else:
        cap = _capacity(B * S, cfg, E)
        out, (me, ce) = _route_and_compute(
            x.reshape(B * S, d), p["router"], p["w_gate"], p["w_up"],
            p["w_down"], cfg=cfg, e_offset=0, e_local=E, capacity=cap)
    aux = _aux(me, ce, cfg, B * S)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_fwd(p["shared"], x, cfg.act)
    return out, aux


def _groups(mesh, axes):
    """The sub-groups of the mesh's ``axes`` that have more than one
    member."""
    return tuple(mesh.axis_group(a) for a in axes
                 if mesh.axis_group(a) is not None and mesh.shape[a] > 1)


class _PsumFn(torch.autograd.Function):
    """A sum over sub-groups (one functional all-reduce each); its
    cotangent passes through unchanged: the sum stands replicated over
    those ranks, each holding the whole cotangent (the transpose of jax's
    ``psum`` in a ``shard_map``)."""

    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed._functional_collectives as funcol
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFn(torch.autograd.Function):
    """The shards of ``t`` along ``dim`` concatenated over a sub-group; its
    cotangent reduce-scattered back along ``dim`` (the transpose of jax's
    tiled ``all_gather``)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        import torch.distributed._functional_collectives as funcol
        ctx.group, ctx.dim = group, dim
        return funcol.wait_tensor(funcol.all_gather_tensor(t.contiguous(),
                                                           dim, group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


class _ScaleGradFn(torch.autograd.Function):
    """The identity forward; the cotangent times ``c`` backward."""

    @staticmethod
    def forward(ctx, t, c):
        ctx.c = c
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _psum(t, mesh, axes):
    """``t`` summed over the mesh's ``axes`` (nothing on a one-member
    mesh)."""
    groups = _groups(mesh, axes)
    return _PsumFn.apply(t, groups) if groups else t


def _gather(t, mesh, axis, dim):
    """The shards of ``t`` along ``dim`` concatenated over ``axis``."""
    groups = _groups(mesh, (axis,))
    return _GatherFn.apply(t, groups[0], dim) if groups else t


def _manual(t, mesh, spec, partial=()):
    """This rank's shard of ``t`` laid out as ``spec``, entering the manual
    region. Its gradient is a partial sum over the mesh axes in
    ``partial``: axes that replicate ``t`` while the body splits its work
    over them (so each rank's gradient is a share), as the ``psum`` that
    jax's autodiff puts on such an input of a ``shard_map``."""
    t = constrain(t, mesh, *spec)
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial
    return t.to_local(grad_placements=[
        Partial() if a in partial else pl
        for a, pl in zip(mesh.axis_names, t.placements)])


def _moe_mesh(p, cfg, x_flat, mesh, data_axes, model_axis):
    """The reference's ``shard_map`` body over ``mesh``: (out ``[T, d]``,
    me ``[E]``, ce ``[E]``), DTensors when x is one.

    Differentiable in x, the router and the expert weights, with the
    transposes of jax's autodiff of the ``shard_map``: the FSDP gathers
    reduce-scatter their cotangent, the sums of ``out`` and ``me`` pass it
    through, and x (over ``model``), the router (over every axis the body
    splits: ``model``, and the data axes in the train layout) and the
    expert weights (over data axes other than the FSDP one) take partial
    gradients. ``me`` is computed alike on every ``model`` rank, so its
    cotangent is cut by ``1/n_model`` there: the partial sums over
    ``model`` then count it once. Routing integers carry no gradient."""
    T = x_flat.shape[0]
    E = cfg.n_experts
    n_data = 1
    for a in data_axes:
        n_data *= mesh.shape[a]
    n_model = mesh.shape[model_axis]
    e_local = max(E // n_model, 1)
    shard_tokens = T % n_data == 0 and n_data > 1
    dspec = (data_axes if len(data_axes) > 1 else data_axes[0]) \
        if shard_tokens else None
    if shard_tokens:
        # train/prefill layout: tokens over data, experts over model, the
        # expert FFN dim FSDP over the last data axis
        fsdp = data_axes[-1]
        cap = _capacity(T // n_data, cfg, e_local)
        w_specs = ((model_axis, None, fsdp), (model_axis, None, fsdp),
                   (model_axis, fsdp, None))
        split = (*data_axes, model_axis)
        w_partial = tuple(a for a in data_axes if a != fsdp)
    else:
        # decode layout: tokens replicated, experts over model
        cap = _capacity(T, cfg, e_local)
        w_specs = ((model_axis, None, None),) * 3
        split, w_partial = (model_axis,), ()
    xl = _manual(x_flat, mesh, (dspec, None), (model_axis,))
    rw = _manual(p["router"], mesh, (None, None), split)
    wg, wu, wd = (_manual(p[k], mesh, spec, w_partial) for k, spec in
                  zip(("w_gate", "w_up", "w_down"), w_specs))
    # the manual region: local tensors and collectives on sub-groups
    if shard_tokens:
        wg = _gather(wg, mesh, fsdp, 2)
        wu = _gather(wu, mesh, fsdp, 2)
        wd = _gather(wd, mesh, fsdp, 1)
    e_off = mesh.axis_rank(model_axis) * e_local
    out, (me, ce) = _route_and_compute(
        xl, rw, wg, wu, wd, cfg=cfg, e_offset=e_off, e_local=e_local,
        capacity=cap)
    out = _psum(out, mesh, (model_axis,))
    if me.requires_grad and n_model > 1:
        me = _ScaleGradFn.apply(me, 1.0 / n_model)
    if shard_tokens:
        me = _psum(me, mesh, data_axes)
        ce = _psum(ce, mesh, data_axes)
    if not is_dtensor(x_flat):
        return out, me, ce
    from torch.distributed.tensor import DTensor
    dm = x_flat.device_mesh
    rep = placements(mesh, P())
    out = DTensor.from_local(out, dm, placements(mesh, P(dspec, None)),
                             run_check=False, shape=x_flat.shape,
                             stride=x_flat.stride())
    return (out, DTensor.from_local(me, dm, rep, run_check=False),
            DTensor.from_local(ce, dm, rep, run_check=False))


def moe_fwd_batched(p, cfg, x):
    """``moe_fwd`` per client of a cohort: x ``[M, B, S, d]`` and leaves
    ``[M, ...]`` (views of the cohort buffer) -> (out ``[M, B, S, d]``, aux
    ``[M]``). Client m routes its own B·S tokens with its own router at
    the capacity of its own token count (``route_batched``); the dispatch
    and the combine are one gather each over the cohort; the expert FFNs
    are one ``[E, C, d] x [E, d, f]`` GEMM per client and product, read
    from each client's expert leaves in place (the leaves' client stride
    is the buffer's row, so folding ``[M, E]`` into one batch axis would
    copy every expert weight)."""
    M, B, S, d = x.shape
    E, T = cfg.n_experts, B * S
    cap = _capacity(T, cfg, E)
    x_flat = x.reshape(M * T, d)
    r = route_batched(x.reshape(M, T, d), p["router"], cfg=cfg,
                      capacity=cap)
    h_in = _dispatch(x_flat, r, M * E, cap).reshape(M, E, cap, d)
    out_buf = torch.cat([_experts(h_in[m], p["w_gate"][m], p["w_up"][m],
                                  p["w_down"][m], cfg.act)
                         for m in range(M)])
    out = _combine(out_buf, r, M * T, cfg.top_k, M * E, x.dtype)
    me = torch.sum(r["probs"], dim=1)                       # [M, E]
    ce = torch.bincount(r["fe"], minlength=M * E).reshape(M, E).to(
        torch.float32)
    out = out.reshape(M, B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_fwd_batched(p["shared"], x, cfg.act)
    return out, _aux(me, ce, cfg, T)
