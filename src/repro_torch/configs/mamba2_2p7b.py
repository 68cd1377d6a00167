"""mamba2-2.7b (Mamba-2, SSD; arXiv:2405.21060) — the paper's main
regime.

The same widths as ``repro.configs.mamba2_2p7b``: 64 layers, d_model
2560 (d_inner 5120: 80 heads of 64), d_state 128, 1 group, conv width 4,
chunk 256, vocab 50280, tied embeddings, RMSNorm, bf16 params, and
``XambaConfig.optimized()`` (CumBA and ReduBA).  About 5.4 GB in bf16.
"""
from repro_torch.core.xamba import XambaConfig
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="mamba2",
    vocab_size=50280, d_model=2560, n_layers=64,
    d_state=128, d_conv=4, expand=2, ssm_head_dim=64, ssm_ngroups=1,
    chunk_size=256, tie_embeddings=True, norm_type="rmsnorm",
    remat="full", scan_layers=True,
    xamba=XambaConfig.optimized(),
)

REDUCED = CONFIG.replace(
    vocab_size=512, d_model=128, n_layers=2, d_state=16, ssm_head_dim=32,
    chunk_size=32, remat="none")
