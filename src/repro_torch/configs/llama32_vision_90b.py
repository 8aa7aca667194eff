"""Llama-3.2-Vision 90B text backbone with gated cross-attention image
layers (copy of ``repro/configs/llama32_vision_90b.py``).

[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment] 100L total
(80 self + 20 gated cross-attn, 1 cross per 5), d_model=8192, 64H GQA kv=8,
head_dim=128, d_ff=28672, vocab=128256. The vision frontend (ViT +
projector) is a stub: the batch carries post-projector patch embeddings
[B, 1600, d_model].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B-scale per assignment)",
    n_layers=100, d_model=8192, d_ff=28672, vocab=128256,
    n_heads=64, n_kv_heads=8, head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5, n_frontend_tokens=1600,
)
