"""SeamlessM4T-Large v2 text decoder + speech encoder backbone, enc-dec
(copy of ``repro/configs/seamless_m4t_large_v2.py``).

[arXiv:2308.11596] 24L encoder + 24L decoder, d_model=1024, 16H kv=16,
head_dim=64, d_ff=8192, vocab=256206. The audio frontend (mel + conv codec)
is a stub: the batch carries frame embeddings [B, n_frames, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    source="arXiv:2308.11596 (SeamlessM4T v2)",
    n_layers=24, d_model=1024, d_ff=8192, vocab=256206,
    n_heads=16, n_kv_heads=16, head_dim=64,
    encoder_layers=24, n_frontend_tokens=4096,
    act="gelu", norm="layernorm",
)
