"""mamba2-130m — the paper's Mamba-2 evaluation subject (hf:mamba2-130m-hf).

The same widths as ``repro.configs.mamba2_130m``: d_model 768, 24 layers,
d_state 128, head_dim 64 (24 heads), 1 group, conv width 4, chunk 256,
vocab 50288, tied embeddings, bf16 params; the training trunk
rematerializes every layer (``remat="full"``), as the JAX config's.
"""
from repro_torch.core.xamba import XambaConfig
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="mamba2",
    vocab_size=50288, d_model=768, n_layers=24,
    d_state=128, d_conv=4, expand=2, ssm_head_dim=64, ssm_ngroups=1,
    chunk_size=256, tie_embeddings=True, scan_layers=True, remat="full",
    xamba=XambaConfig.optimized(),
)

REDUCED = CONFIG.replace(vocab_size=512, d_model=128, n_layers=2,
                         d_state=16, ssm_head_dim=32, chunk_size=32)
