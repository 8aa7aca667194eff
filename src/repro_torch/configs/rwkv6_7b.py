"""RWKV-6 "Finch" 7B — attention-free SSM with data-dependent decay (copy
of ``repro/configs/rwkv6_7b.py``).

[arXiv:2404.05892] 32L, d_model=4096, d_ff=14336, vocab=65536; head_dim=64
(64 WKV heads), low-rank data-dependent decay (ddlerp), per-head bonus u.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", source="arXiv:2404.05892 (RWKV-6 Finch)",
    n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
    n_heads=64, n_kv_heads=64, head_dim=64,
    ssm_kind="rwkv6", ssm_state=64,
    act="relu_sq",  # RWKV channel-mix uses squared ReLU
    norm="layernorm",
)
