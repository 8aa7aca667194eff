"""DeepSeek-V3 671B — MLA + 1 shared / 256 routed top-8 MoE + MTP (copy of
``repro/configs/deepseek_v3_671b.py``).

[arXiv:2412.19437] 61L (first 3 dense, d_ff=18432), d_model=7168, 128 heads,
MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), MoE intermediate
2048, vocab=129280, MTP depth 1.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437 (DeepSeek-V3)",
    n_layers=61, d_model=7168, d_ff=18432, vocab=129280,
    n_heads=128, n_kv_heads=128, head_dim=128,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048, n_dense_layers=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    mtp=True,
)
