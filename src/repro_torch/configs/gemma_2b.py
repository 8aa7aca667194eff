"""Gemma-2B — GeGLU, head_dim=256, MQA (1 KV head) (copy of
``repro/configs/gemma_2b.py``).

[arXiv:2403.08295] 18L, d_model=2048, 8H kv=1, head_dim=256, d_ff=16384
(GeGLU hidden), vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", source="arXiv:2403.08295 (Gemma)",
    n_layers=18, d_model=2048, d_ff=16384, vocab=256000,
    n_heads=8, n_kv_heads=1, head_dim=256,
    act="geglu", tie_embeddings=True,
)
