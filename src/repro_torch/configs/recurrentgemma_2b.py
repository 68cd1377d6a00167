"""recurrentgemma-2b (Griffin: RG-LRU recurrent blocks + local attention,
2:1; arXiv:2402.19427, hf:google/recurrentgemma-2b).

The same widths as ``repro.configs.recurrentgemma_2b``: 26 layers in the
pattern (recurrent, recurrent, attention), d_model 2560, lru_width 2560,
10 query heads and 1 KV head of 256, d_ff 7680 (GeGLU), vocab 256000,
tied embeddings scaled by sqrt(d_model), the Gemma RMSNorm, a 2048-token
sliding window and a logit soft-cap of 30.  ``remat`` and
``scan_layers`` are the JAX package's training / layout knobs, kept for
parity; the port always serves with its per-layer loop.
"""
from repro_torch.core.xamba import XambaConfig
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="recurrentgemma",
    vocab_size=256000, d_model=2560, n_layers=26,
    n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, mlp_type="geglu", norm_type="gemma_rmsnorm",
    embed_scale=True, tie_embeddings=True,
    lru_width=2560, sliding_window=2048,
    block_pattern=("recurrent", "recurrent", "attention"),
    attn_logit_softcap=30.0,
    remat="full", scan_layers=True,
    xamba=XambaConfig.optimized(),
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=3, n_heads=4, n_kv_heads=1,
    head_dim=32, d_ff=256, lru_width=128, sliding_window=64, remat="none")
