"""qwen3-moe-30b-a3b (MoE transformer; hf:Qwen/Qwen3-30B-A3B).

The same widths as ``repro.configs.qwen3_moe_30b_a3b``: 48 layers,
d_model 2048, 32 query heads and 4 KV heads of 128, vocab 151936,
RMSNorm, RoPE theta 1e6, an untied ``lm_head``, and in every layer an
MoE of 128 SwiGLU experts of width 768, top-8 with renormalized gates and
capacity factor 1.25 (``nn/moe.py``).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="transformer",
    vocab_size=151936, d_model=2048, n_layers=48,
    n_heads=32, n_kv_heads=4, head_dim=128,
    mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1e6, tie_embeddings=False,
    moe=True, n_experts=128, n_experts_per_token=8, moe_d_ff=768,
    moe_renormalize=True, capacity_factor=1.25,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, moe_d_ff=64, n_experts=8, n_experts_per_token=2,
    remat="none")
