"""Analytic MODEL_FLOPS estimates (the 'useful compute' numerator): a
copy of ``repro.launch.flops``, pure arithmetic on the config.

MODEL_FLOPS = 6 * N * D (train) / 2 * N * D (inference forward) with
N = *active* params (MoE counts top-k experts only), plus the standard
attention term 2 * 2 * b * h * s^2/2 * head_dim (causal halves it) that the
6ND rule omits.  The ratio MODEL_FLOPS / (HLO_FLOPs * chips) exposes remat
recompute and dispatch overhead in the compiled module.
"""
from __future__ import annotations

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.base import ModelConfig


def active_param_count(cfg: ModelConfig, total_params: int) -> int:
    if not cfg.moe:
        return total_params
    # expert tensors: wi + wg + wo = 3 * d * f per expert per layer
    per_expert_layer = 3 * cfg.d_model * cfg.moe_d_ff
    total_expert = cfg.n_layers * cfg.n_experts * per_expert_layer
    active_expert = cfg.n_layers * cfg.n_experts_per_token * per_expert_layer
    return total_params - total_expert + active_expert


def attention_flops(cfg: ModelConfig, batch: int, seq: int,
                    causal: bool = True) -> float:
    if cfg.family in ("mamba", "mamba2"):
        # SSD/scan state math: ~ 2 * (3 or so) * b * l * h * p * n; use the
        # dominant intra-chunk term 2*b*l*chunk*h*p + state terms.
        h = (cfg.expand * cfg.d_model) // cfg.ssm_head_dim \
            if cfg.family == "mamba2" else cfg.expand * cfg.d_model
        n = cfg.d_state
        p = cfg.ssm_head_dim if cfg.family == "mamba2" else 1
        chunk = min(cfg.chunk_size, seq)
        per_layer = 2 * batch * seq * h * p * (chunk + 2 * n)
        return float(per_layer * cfg.n_layers)
    n_attn = cfg.n_layers
    if cfg.family == "recurrentgemma":
        pattern = cfg.block_pattern or ("recurrent", "recurrent", "attention")
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if pattern[i % len(pattern)] == "attention")
    eff = seq
    if cfg.sliding_window:
        eff = min(seq, cfg.sliding_window * 2)
    s2 = seq * eff / (2 if causal else 1)
    return float(n_attn * 2 * 2 * batch * cfg.n_heads * s2 * cfg.head_dim)


def model_flops(cfg: ModelConfig, shape: ShapeSpec, total_params: int
                ) -> float:
    n_active = active_param_count(cfg, total_params)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens + \
            3.0 * attention_flops(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens + \
            attention_flops(cfg, shape.global_batch, shape.seq_len)
    # decode: one token against a seq_len cache
    tokens = shape.global_batch
    attn = 0.0
    if cfg.family not in ("mamba", "mamba2"):
        eff = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        n_attn = cfg.n_layers
        if cfg.family == "recurrentgemma":
            pattern = cfg.block_pattern or ("recurrent", "recurrent",
                                            "attention")
            n_attn = sum(1 for i in range(cfg.n_layers)
                         if pattern[i % len(pattern)] == "attention")
        attn = n_attn * 2 * 2 * shape.global_batch * cfg.n_heads * eff * \
            cfg.head_dim
    return 2.0 * n_active * tokens + attn
