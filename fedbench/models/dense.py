"""The dense decoder family (Qwen2): its parameter layout, initial
distribution, forward FLOPs and plain float32 reference loss.

The reference is the published Qwen2 block in plain torch, float32, one
client at a time and no kernel: pre-norm RMSNorm (ε from the file), grouped
query attention with q/k/v biases, rotary position embedding on the two
halves of each head (θ from the file), a causal softmax over the keys (a
sliding window where the file sets one), SwiGLU MLP, a final RMSNorm and
the (tied) unembedding, then the mean next-token cross entropy. Vocabulary
rows are padded to a multiple of 32; the padded logits are masked out.
It imports nothing of the program. Matmuls run in float32 proper: the
caller turns TF32 off (``set_tf32``), and the benchmark's control turns
it on.

The parameters are one nested dict whose layers are stacked on a leading
``[L]`` axis; ``param_shapes`` lists its leaves in sorted key order at
every level, which is the order of the flat buffer whose index the
directions are keyed on.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VOCAB_PAD = 32
NEG_INF = -1e30


def padded_vocab(cfg) -> int:
    return cfg["vocab"] + (-cfg["vocab"]) % VOCAB_PAD


def set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def block_shapes(cfg) -> dict:
    """One layer's leaves (unstacked), nested."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
            "wo": (hq * hd, d)}
    if cfg.get("qkv_bias"):
        attn.update(bq=(hq * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    return {"attn": attn,
            "mlp": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)},
            "norm1": {"scale": (d,)}, "norm2": {"scale": (d,)}}


def tree_shapes(cfg) -> dict:
    L, d, vp = cfg["n_layers"], cfg["d_model"], padded_vocab(cfg)

    def stack(t):
        return ({k: stack(v) for k, v in t.items()} if isinstance(t, dict)
                else (L,) + tuple(t))

    embed = {"tok": (vp, d)}
    if not cfg.get("tie_embeddings"):
        embed["unembed"] = (d, vp)
    return {"blocks": stack(block_shapes(cfg)), "embed": embed,
            "final_norm": {"scale": (d,)}}


def flat_leaves(tree, prefix=()):
    """(path, shape) of every leaf, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flat_leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), tuple(v)))
    return out


def param_shapes(cfg):
    return flat_leaves(tree_shapes(cfg))


# leaves drawn as constants, by name: norm scales at 1, biases at 0
ONES = ("scale",)
ZEROS = ("bq", "bk", "bv")


def leaf_init(path, shape):
    """How the benchmark draws a leaf: ``("fill", value)`` or ``("normal",
    std)``. Matrices are N(0, 1/fan_in), the token table N(0, 0.02²)."""
    name = path[-1]
    if name in ONES:
        return "fill", 1.0
    if name in ZEROS:
        return "fill", 0.0
    if name == "tok":
        return "normal", 0.02
    return "normal", 1.0 / math.sqrt(shape[-2])


def matmul_params(cfg) -> int:
    """Weights a token multiplies: every layer's matrices and the
    unembedding over the true vocabulary."""
    per_layer = sum(math.prod(s) for _, s in flat_leaves(block_shapes(cfg))
                    if len(s) == 2)
    return cfg["n_layers"] * per_layer + cfg["d_model"] * cfg["vocab"]


def attention_pairs(seq: int, window: int) -> int:
    """(query, key) pairs a causal attention keeps over ``seq`` positions,
    within ``window`` positions back when it is set."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_flops(cfg, seq: int) -> int:
    """q·k and p·v multiply-adds of one sequence, every layer and head."""
    return (4 * cfg["head_dim"] * cfg["n_heads"] * cfg["n_layers"]
            * attention_pairs(seq, cfg.get("sliding_window", 0)))


def forward_flops(cfg, seq: int) -> int:
    """Model FLOPs of one sequence's forward: 2 per matmul weight and
    token, plus the attention's own."""
    return 2 * matmul_params(cfg) * seq + attention_flops(cfg, seq)


# ---------------------------------------------------------------------------
# the plain reference


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """x [B, S, H, D]: the two halves of each head rotated by position."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(p, cfg, x):
    B, S, _ = x.shape
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.get("qkv_bias"):
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, hq, hd), cfg["rope_theta"])
    k = rope(k.reshape(B, S, hkv, hd), cfg["rope_theta"])
    v = v.reshape(B, S, hkv, hd)
    g = hq // hkv
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    pos = torch.arange(S, device=x.device)
    keep = pos[None, :] <= pos[:, None]
    w = cfg.get("sliding_window", 0)
    if w:
        keep &= pos[:, None] - pos[None, :] < w
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, S, hq * hd) @ p["wo"]


def mlp(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def embed(params, cfg, tokens):
    h = params["embed"]["tok"][tokens.long()]
    if cfg.get("embed_scale"):
        h = h * float(torch.tensor(math.sqrt(cfg["d_model"]),
                                   dtype=torch.float32))
    return h


def loss(params, cfg, tokens, labels):
    """Mean next-token cross entropy of one client's batch ``[B, S]``."""
    eps = cfg["norm_eps"]
    h = embed(params, cfg, tokens)
    blocks = params["blocks"]
    for i in range(cfg["n_layers"]):
        p = _layer(blocks, i)
        h = h + attention(p["attn"], cfg, rmsnorm(h, p["norm1"]["scale"], eps))
        h = h + mlp(p["mlp"], rmsnorm(h, p["norm2"]["scale"], eps))
    h = rmsnorm(h, params["final_norm"]["scale"], eps)
    e = params["embed"]
    w = e["tok"].T if cfg.get("tie_embeddings") else e["unembed"]
    logits = h @ w
    vp = logits.shape[-1]
    if vp != cfg["vocab"]:
        logits[..., cfg["vocab"]:] = NEG_INF
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked)


def _layer(stacked, i):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]
