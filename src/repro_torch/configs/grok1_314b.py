"""grok-1-314b (MoE transformer; hf:xai-org/grok-1).

The same widths as ``repro.configs.grok1_314b``: 64 layers, d_model
6144, 48 query heads and 8 KV heads of 128, vocab 131072, RMSNorm, an
attention logit soft-cap of 30 (so whole-sequence attention never takes
the flash kernel: ``nn/attention.py: full_attention``), RoPE theta 1e4,
an untied ``lm_head``, and in every layer an MoE of 8 GeGLU experts of
width 32768, top-2 with renormalized gates and capacity factor 1.25.
``moe_cap_batch_sharding`` is the JAX package's sharding hint, kept as a
name.  At full depth it does not fit one 80 GB card.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="transformer",
    vocab_size=131072, d_model=6144, n_layers=64,
    n_heads=48, n_kv_heads=8, head_dim=128,
    mlp_type="geglu", norm_type="rmsnorm",
    attn_logit_softcap=30.0,
    rope_theta=1e4, tie_embeddings=False,
    moe=True, n_experts=8, n_experts_per_token=2, moe_d_ff=32768,
    moe_renormalize=True, capacity_factor=1.25,
    moe_cap_batch_sharding=True,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, moe_d_ff=128, n_experts=4, n_experts_per_token=2,
    remat="none")
