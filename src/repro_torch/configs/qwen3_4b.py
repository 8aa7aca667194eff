"""Qwen3-4B — dense GQA with qk_norm (copy of
``repro/configs/qwen3_4b.py``).

[hf:Qwen/Qwen3-8B family, 4B per assignment] 36L, d_model=2560, 32H kv=8,
head_dim=128, d_ff=9728, vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense", source="hf:Qwen/Qwen3-8B (4B per assignment)",
    n_layers=36, d_model=2560, d_ff=9728, vocab=151936,
    n_heads=32, n_kv_heads=8, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
