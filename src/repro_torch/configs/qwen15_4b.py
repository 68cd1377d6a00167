"""qwen1.5-4b (dense transformer; hf:Qwen/Qwen1.5-4B).

The same widths as ``repro.configs.qwen15_4b``: 40 layers, d_model 2560,
20 query and 20 KV heads of 128, d_ff 6912 (SwiGLU), vocab 151936,
RMSNorm, biases on the q / k / v projections, RoPE theta 5e6 and an
untied ``lm_head``.  ``remat`` and ``scan_layers`` are kept for parity,
as in ``configs/gemma_2b.py``.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="transformer",
    vocab_size=151936, d_model=2560, n_layers=40,
    n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, mlp_type="swiglu", norm_type="rmsnorm",
    qkv_bias=True, rope_theta=5e6, tie_embeddings=False,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, remat="none")
