"""mamba-130m — the paper's Mamba-1 evaluation subject (hf:mamba-130m-hf).

The same widths as ``repro.configs.mamba_130m``: d_model 768, 24 layers,
d_state 16, conv width 4, expand 2 (d_inner 1536), dt_rank 48, vocab
50280, tied embeddings, bf16 params, the associative scan for prefill.
"""
from repro_torch.core.xamba import XambaConfig
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba-130m", family="mamba",
    vocab_size=50280, d_model=768, n_layers=24,
    d_state=16, d_conv=4, expand=2, dt_rank=48,
    tie_embeddings=True,
    xamba=XambaConfig.optimized(),
)

REDUCED = CONFIG.replace(vocab_size=512, d_model=128, n_layers=2, dt_rank=8)
