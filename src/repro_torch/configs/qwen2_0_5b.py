"""Qwen2-0.5B — dense GQA with QKV bias (copy of
``repro/configs/qwen2_0_5b.py``).

[arXiv:2407.10671] 24L, d_model=896, 14H kv=2, head_dim=64, d_ff=4864,
vocab=151936, qkv bias, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", source="arXiv:2407.10671 (Qwen2)",
    n_layers=24, d_model=896, d_ff=4864, vocab=151936,
    n_heads=14, n_kv_heads=2, head_dim=64,
    qkv_bias=True, tie_embeddings=True,
)
