"""Configs: a jax-free copy of the reference's ``FedZOConfig``,
``MLAConfig``, ``ModelConfig``, ``ShapeConfig`` and ``INPUT_SHAPES``
(``repro/configs/base.py``).

The field sets and defaults are the reference's, so a config built for one
package means the same run in the other. The port builds all six model
families (dense, moe with MLA and MTP, ssm, hybrid, encdec, vlm); fields
that select a route it does not have yet are rejected where they are used
(``core/fedzo.py``, ``models/api.py``), never silently ignored.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class FedZOConfig:
    """Paper Algorithm 1 hyperparameters."""
    n_devices: int = 50        # N
    n_participating: int = 10  # M (<= N); == N means full participation
    local_iters: int = 5       # H
    lr: float = 1e-3           # eta
    mu: float = 1e-3           # smoothing step size
    b1: int = 25               # data minibatch size
    b2: int = 20               # number of perturbation directions
    estimator: str = "sphere"  # sphere (paper) | gaussian | rademacher | coordinate
    central: bool = False      # two-sided difference (O(mu^2) bias, +1 query)
    direction_dtype: str = "float32"
    # flat-buffer hot path: perturb/update fused into streaming kernels over
    # one padded 1-D parameter buffer, directions regenerated in-kernel from
    # the counter convention
    flat_params: bool = False
    direction_conv: str = "tree"
    batch_directions: bool = False
    prng_impl: str = "threefry2x32"
    flat_block_rows: int = 0   # pad granularity in 128-lane rows; 0 = 512
    server_momentum: float = 0.0  # FedOpt-style momentum on aggregated deltas
    seed: int = 0
    # AirComp (Section IV)
    aircomp: bool = False
    snr_db: float = 0.0        # P / sigma_w^2
    h_min: float = 0.8
    # channel-truncation scheduling (Sec. IV-A)
    channel_schedule: bool = False
    channel_model: object = None
    # FedAvg-style n_i/n weighting of the sampled clients' deltas
    weight_by_size: bool = False
    delta_compression: str = "dense"  # dense | seed
    strategy: str = "fedzo"
    prox_mu: float = 0.0
    dyn_alpha: float = 0.0
    surrogate_beta: float = 0.5
    surrogate_fraction: float = 0.5


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    source: str                 # citation for the assigned config
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # 0 = full causal; >0 = window size
    long_context_window: int = 16_384  # window used for long_500k decode
    # ffn flavor
    act: str = "swiglu"          # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # expert intermediate size
    n_dense_layers: int = 0      # leading dense layers (DeepSeek: 3)
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25
    # MLA / MTP (DeepSeek)
    mla: Optional[MLAConfig] = None
    mtp: bool = False            # multi-token-prediction extra head
    # SSM
    ssm_kind: str = ""           # rwkv6 | mamba (hybrid uses mamba)
    ssm_state: int = 0
    # enc-dec / VLM
    encoder_layers: int = 0
    cross_attn_every: int = 0    # vlm: 1 cross-attn layer per this many self layers
    n_frontend_tokens: int = 0   # stubbed modality tokens (audio frames / image patches)
    # misc
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: tiny dims, same structure
        (the reference's rule, field for field)."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            dtype="float32",
            long_context_window=64,
        )
        if self.n_heads:
            kw["n_heads"] = min(self.n_heads, 4)
            kw["n_kv_heads"] = min(self.n_kv_heads, 2)
            kw["head_dim"] = min(self.head_dim, 32) if self.head_dim else 0
        if self.n_experts:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
            kw["moe_d_ff"] = min(self.moe_d_ff, 128)
            kw["n_dense_layers"] = min(self.n_dense_layers, 1)
            # ample capacity so smoke tests see no token dropping (capacity
            # drops legitimately differ between batched prefill and decode)
            kw["capacity_factor"] = 4.0
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 8)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 16
        if self.sliding_window:
            kw["sliding_window"] = 32
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
