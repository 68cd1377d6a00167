"""gemma-2b (dense transformer; arXiv:2403.08295, hf:google/gemma-2b).

The same widths as ``repro.configs.gemma_2b``: 18 layers, d_model 2048,
8 query heads and 1 KV head (MQA) of 256, d_ff 16384 (GeGLU), vocab
256000, the Gemma RMSNorm, tied embeddings scaled by sqrt(d_model), RoPE
theta 1e4, no sliding window and no logit soft-cap.  ``remat`` and
``scan_layers`` are the JAX package's training / layout knobs, kept for
parity; the port always serves with its per-layer loop.  The flash
attention kernel is a config override (``use_flash=True``), as in the
JAX package.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="transformer",
    vocab_size=256000, d_model=2048, n_layers=18,
    n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, mlp_type="geglu", norm_type="gemma_rmsnorm",
    embed_scale=True, tie_embeddings=True, rope_theta=1e4,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=1,
    head_dim=32, d_ff=256, remat="none")
