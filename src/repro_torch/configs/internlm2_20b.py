"""internlm2-20b (dense transformer, GQA; arXiv:2403.17297).

The same widths as ``repro.configs.internlm2_20b``: 48 layers, d_model
6144, 48 query heads and 8 KV heads of 128, d_ff 16384 (SwiGLU), vocab
92544, RMSNorm, RoPE theta 1e6 and an untied ``lm_head``.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="transformer",
    vocab_size=92544, d_model=6144, n_layers=48,
    n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1e6, tie_embeddings=False,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, remat="none")
