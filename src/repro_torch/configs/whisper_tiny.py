"""whisper-tiny (encoder-decoder; arXiv:2212.04356).

The same widths as ``repro.configs.whisper_tiny``: 4 encoder and 4
decoder layers, d_model 384, 6 heads of 64, d_ff 1536 (the plain GeLU
MLP), vocab 51865, LayerNorm, tied embeddings, 1500 encoder frames.  The
conv frontend is a stub, as in the JAX package: a batch carries the
precomputed frame embeddings (b, 1500, 384) as ``frames``.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="whisper",
    vocab_size=51865, d_model=384, n_layers=4, encoder_layers=4,
    n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, mlp_type="mlp", norm_type="layernorm",
    encoder_seq=1500, tie_embeddings=True,
    remat="none", scan_layers=False,
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=64, n_layers=2, encoder_layers=2, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, encoder_seq=32)
