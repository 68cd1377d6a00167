"""llava-next-mistral-7b (transformer with the vision stub;
hf:llava-hf/llava-v1.6-mistral-7b-hf).

The same widths as ``repro.configs.llava_next_mistral_7b``: a mistral
backbone of 32 layers, d_model 4096, 32 query heads and 8 KV heads of
128, d_ff 14336 (SwiGLU), vocab 32000, RMSNorm, RoPE theta 1e6 and an
untied ``lm_head``.  The vision tower is a stub: ``prefill`` and ``loss``
take precomputed patch embeddings ``batch["image_embeds"]`` (b, 576,
d_model) and put them ahead of the token embeddings
(``models/transformer.py``); the engines pass tokens only.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="transformer",
    vocab_size=32000, d_model=4096, n_layers=32,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=1e6, tie_embeddings=False,
    frontend="vision_stub", num_patches=576,
    remat="full", scan_layers=True,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, num_patches=16, remat="none")
