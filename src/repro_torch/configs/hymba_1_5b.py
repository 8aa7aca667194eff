"""Hymba-1.5B — hybrid parallel attention + Mamba heads in every layer
(copy of ``repro/configs/hymba_1_5b.py``).

[arXiv:2411.13676] 32L, d_model=1600, 25H GQA kv=5, head_dim=64, d_ff=5504,
vocab=32001, ssm_state=16. Attention and Mamba branches run in parallel on
the same input and their outputs are averaged.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676 (Hymba)",
    n_layers=32, d_model=1600, d_ff=5504, vocab=32001,
    n_heads=25, n_kv_heads=5, head_dim=64,
    ssm_kind="mamba", ssm_state=16,
    sliding_window=1024,  # Hymba uses SWA for most attention layers
)
