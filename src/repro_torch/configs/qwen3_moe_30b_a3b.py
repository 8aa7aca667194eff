"""Qwen3-30B-A3B — 128-expert top-8 MoE, GQA (copy of
``repro/configs/qwen3_moe_30b_a3b.py``).

[hf:Qwen/Qwen3-30B-A3B] 48L, d_model=2048, 32H kv=4, head_dim=128,
expert d_ff=768, vocab=151936, 128 experts top-8, no shared expert.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, d_ff=768, vocab=151936,
    n_heads=32, n_kv_heads=4, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    n_experts=128, top_k=8, n_shared_experts=0, moe_d_ff=768, n_dense_layers=0,
)
