"""Qwen1.5-32B — dense with QKV bias, full MHA (kv == heads) (copy of
``repro/configs/qwen15_32b.py``).

[hf:Qwen/Qwen1.5-0.5B family, 32B per assignment] 64L, d_model=5120,
40H kv=40, head_dim=128, d_ff=27392, vocab=152064, qkv bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", source="hf:Qwen/Qwen1.5-0.5B (32B per assignment)",
    n_layers=64, d_model=5120, d_ff=27392, vocab=152064,
    n_heads=40, n_kv_heads=40, head_dim=128,
    qkv_bias=True,
)
