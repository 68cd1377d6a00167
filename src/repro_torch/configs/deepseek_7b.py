"""deepseek-7b (dense transformer, llama architecture; arXiv:2401.02954).

The same widths as ``repro.configs.deepseek_7b``: 30 layers, d_model
4096, 32 query and 32 KV heads of 128, d_ff 11008 (SwiGLU), vocab
102400, RMSNorm, RoPE theta 1e4 and an untied ``lm_head``.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="transformer",
    vocab_size=102400, d_model=4096, n_layers=30,
    n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1e4, tie_embeddings=False,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, remat="none")
