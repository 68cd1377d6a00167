"""RecurrentGemma (Griffin): RG-LRU recurrent blocks and local attention,
2:1 (port of ``repro.models.recurrentgemma``).

Each layer is RMSNorm -> temporal block (RG-LRU or local MQA attention)
-> residual, then RMSNorm -> GeGLU MLP -> residual; the blocks follow
``block_pattern`` (recurrent, recurrent, attention) over ``n_layers``.
Embeddings are tied (with ``tie_embeddings`` off too, as in the JAX
package) and scaled by sqrt(d_model), cast to the stream
dtype first (in bf16 that is 50.5, not 50.596); the logits are fp32 and
soft-capped, ``tanh(l / c) * c``.

Params mirror the JAX tree (group-stacked ``groups`` and a ``tail``) so
that a seed draws each leaf with the JAX package's rule; the port walks
them as a per-layer list (``nn/params.py: per_layer``).  The serving
cache is one flat :class:`RGemmaCache` with the batch on axis 1, so the
engines' row operations (``serve/state_pool.py``) work unchanged: the
recurrent layers' conv tails (n_rec, b, d_conv-1, w) in the cache dtype
and ``h`` (n_rec, b, w) fp32, the attention layers' k and v (n_attn, b,
T, n_kv, head_dim) with ``T = min(max_seq, sliding_window)``: a ring when
the window fits in ``max_seq``, else linear.

Positions: ``prefill`` starts every row at 0; ``prefill_chunk`` and
``decode_step`` take ``index`` from the host (an int for the wave engine,
a ``(b,)`` array for the continuous engine's rows).  RoPE, the cache
writes and the masks all use it; the RG-LRU layers carry position in
their state.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import base
from repro_torch.nn import attention, layers, mlp as mlp_mod, ssm
from repro_torch.nn.params import stack_specs


class RGemmaCache(NamedTuple):
    conv: torch.Tensor   # (n_rec, b, d_conv-1, lru_width), cache dtype
    h: torch.Tensor      # (n_rec, b, lru_width), fp32
    k: torch.Tensor      # (n_attn, b, T, n_kv, head_dim), cache dtype
    v: torch.Tensor      # (n_attn, b, T, n_kv, head_dim), cache dtype


class RecurrentGemma(base.DecodeAPI):
    """Layer stack = ``n_groups`` whole pattern groups + a tail; runs on
    ``device`` (default ``cuda``).  W8 weights (``nn/quant.py``) go
    through ``layers.linear``'s ``qdot`` (kernel 10 on the card), the
    ActiBA gated MLP under ``pallas()`` through kernel 10's gated PWL form,
    and the decode step's gates to kernel 6 dequantized once
    (:meth:`decode_view`)."""

    def __init__(self, cfg: base.ModelConfig, device: DeviceLike = None):
        # The logits are always tied: the JAX RecurrentGemma has no
        # ``lm_head`` and reads no ``tie_embeddings``, so a config with the
        # flag off runs as one with it on.
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pattern = tuple(cfg.block_pattern or
                             ("recurrent", "recurrent", "attention"))
        self.layer_kinds = [self.pattern[i % len(self.pattern)]
                            for i in range(cfg.n_layers)]
        self.n_groups = cfg.n_layers // len(self.pattern)
        self.n_tail = cfg.n_layers - self.n_groups * len(self.pattern)
        # Layer i's slot in the cache's recurrent or attention stack.
        counts = {"recurrent": 0, "attention": 0}
        self.slot = []
        for kind in self.layer_kinds:
            self.slot.append(counts[kind])
            counts[kind] += 1
        self.n_rec, self.n_attn = counts["recurrent"], counts["attention"]

    # ---------------- params ----------------
    def _block_specs(self, kind: str) -> dict:
        cfg = self.cfg
        block = {
            "ln_mix": layers.norm_specs(cfg.d_model, norm_type=cfg.norm_type),
            "ln_mlp": layers.norm_specs(cfg.d_model, norm_type=cfg.norm_type),
            "mlp": mlp_mod.mlp_specs(cfg),
        }
        if kind == "recurrent":
            block["rglru"] = ssm.rglru_specs(cfg)
        else:
            block["attn"] = attention.attention_specs(cfg)
        return block

    def param_specs(self) -> dict:
        cfg = self.cfg
        specs = {
            "embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
            "final_norm": layers.norm_specs(cfg.d_model,
                                            norm_type=cfg.norm_type),
        }
        if self.n_groups:
            specs["groups"] = stack_specs(
                {str(j): self._block_specs(kind)
                 for j, kind in enumerate(self.pattern)}, self.n_groups)
        base_i = self.n_groups * len(self.pattern)
        specs["tail"] = {str(i): self._block_specs(self.layer_kinds[base_i + i])
                         for i in range(self.n_tail)}
        return specs

    def decode_view(self, params) -> dict:
        """``params`` with each recurrent layer carrying kernel 6's
        operands (``ssm.rglru_kernel_operands``: the small ones fp32, the
        gate weights as stored, W8 gate weights dequantized to fp32), so
        no step casts or dequantizes them again.  Build it once per weight
        set; every entry point takes either form."""
        return dict(params, layers=[
            dict(p, rglru=dict(p["rglru"], kernel=ssm.rglru_kernel_operands(
                p["rglru"]))) if "rglru" in p else p
            for p in params["layers"]])

    # ---------------- trunk ----------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = layers.embed(params["embed"], tokens)
        if self.cfg.embed_scale:
            # sqrt(d_model) rounded to the stream dtype first (np.sqrt
            # gives float64; the JAX package casts it to x's dtype).
            x = x * torch.tensor(np.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = layers.unembed(
            params["embed"], layers.norm(params["final_norm"], x,
                                         norm_type=cfg.norm_type))
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def _trunk(self, params, x: torch.Tensor, positions: torch.Tensor,
               cache=None, cache_index=None) -> Tuple[torch.Tensor, Any]:
        """The layers in order; with a cache, each layer writes its new
        state into its slice of one freshly allocated cache.  Without one
        (the training trunk) each layer runs under ``cfg.remat``."""
        new = None if cache is None else RGemmaCache(
            *(torch.empty_like(leaf) for leaf in cache))
        layer = self._layer if cache is not None else \
            base.remat(self._layer, self.cfg.remat)
        for i, p in enumerate(params["layers"]):
            x = layer(i, p, x, positions, cache, new, cache_index)
        return x, new

    def _layer(self, i: int, p, x: torch.Tensor, positions: torch.Tensor,
               cache, new, cache_index) -> torch.Tensor:
        """Layer ``i``: its mixer (RG-LRU or local attention) and MLP."""
        cfg = self.cfg
        s = self.slot[i]
        hin = layers.norm(p["ln_mix"], x, norm_type=cfg.norm_type)
        if self.layer_kinds[i] == "recurrent":
            h, _ = ssm.rglru_apply(
                p["rglru"], cfg, hin,
                None if cache is None else
                ssm.RGLRUState(cache.conv[s], cache.h[s]),
                out=None if cache is None else
                ssm.RGLRUState(new.conv[s], new.h[s]))
        else:
            h, _ = attention.apply(
                p["attn"], cfg, hin, positions=positions,
                cache=None if cache is None else
                attention.KVCache(cache.k[s], cache.v[s]),
                cache_index=cache_index, causal=True,
                window=cfg.sliding_window,
                out=None if cache is None else
                attention.KVCache(new.k[s], new.v[s]))
        x = x + h
        return x + mlp_mod.apply(p["mlp"], cfg, layers.norm(
            p["ln_mlp"], x, norm_type=cfg.norm_type))

    def _positions(self, pos: np.ndarray) -> torch.Tensor:
        return torch.tensor(pos, dtype=torch.long, device=self.device)

    # ---------------- training ----------------
    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """The training loss (value and metrics): the cache-less trunk,
        each layer under ``cfg.remat`` (kernel 8 in the RG-LRU layers under
        a ``pallas`` CumBA mode, which has no gradient: ``kernels/ops.py``
        raises under grad), next-token cross entropy with the z-loss."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = self._positions(np.arange(tokens.shape[1])[None, :])
        x, _ = self._trunk(params, x, positions)
        logits = self._logits(params, x)
        loss, metrics = base.cross_entropy_loss(logits[:, :-1],
                                                batch["labels"][:, 1:])
        metrics["loss_total"] = loss
        return loss, metrics

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> RGemmaCache:
        """Zero state for ``batch`` rows whose prompt and continuation fit
        in ``max_seq`` positions."""
        cfg = self.cfg
        T = min(max_seq, cfg.sliding_window or max_seq)
        one = tuple(ssm.rglru_init_state(cfg, batch, dtype, self.device)) + \
            tuple(attention.init_cache(cfg, batch, T, dtype, self.device))
        return RGemmaCache(*(leaf.new_zeros((n,) + tuple(leaf.shape))
                             for leaf, n in zip(one, (self.n_rec, self.n_rec,
                                                      self.n_attn,
                                                      self.n_attn))))

    def cache_batch_axes(self, cache):
        """Each cache leaf's batch axis: 1 behind the stacked layer axis."""
        return RGemmaCache(*(1 for _ in cache))

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """Whole prompt ``batch["tokens"]`` (b, l), every row from
        position 0 -> (last logits (b, V) fp32, cache after the prompt)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, new = self._trunk(
            params, x, self._positions(np.arange(tokens.shape[1])[None, :]),
            cache)
        return self._logits(params, x[:, -1]), new

    def _chunk_hidden(self, params, tokens, cache, index):
        """A chunk whose first token sits at ``index`` (int or per row):
        the RG-LRU layers resume from the carried state, the attention
        layers append the chunk's k / v at ``index .. index + l - 1`` and
        attend to the cached prefix (``nn/attention.py:
        chunk_attention``)."""
        idx = np.asarray(index, np.int64)
        pos = base.chunk_positions(idx, *tokens.shape)
        return self._trunk(params, self._embed(params, tokens),
                           self._positions(pos), cache, idx)

    def decode_step(self, params, token, cache, index
                    ) -> Tuple[torch.Tensor, Any]:
        """token (b, 1) at position ``index`` (int or per row) -> (logits
        (b, V) fp32, cache)."""
        idx = np.asarray(index, np.int64)
        b = token.shape[0]
        pos = np.broadcast_to(idx.reshape(-1, 1), (b, 1))
        x = self._embed(params, token)
        x, new = self._trunk(params, x, self._positions(pos), cache, idx)
        return self._logits(params, x[:, 0]), new

    def export_state(self, cache, index, rows):
        """Snapshot of ``rows``' state: fresh tensors (batch ``len(rows)``)
        on the cache's device, never views of ``cache``; KV rows are kept
        whole (``index`` is ignored)."""
        del index
        idx = torch.as_tensor(list(rows), device=cache.conv.device)
        return RGemmaCache(*(leaf.index_select(1, idx) for leaf in cache))

    def import_state(self, cache, index, rows, snapshot):
        """Write snapshot row ``j`` into ``cache`` row ``rows[j]`` in place
        (the inverse of :meth:`export_state`); returns ``cache``."""
        del index
        idx = torch.as_tensor(list(rows), device=cache.conv.device)
        for leaf, snap in zip(cache, snapshot):
            leaf.index_copy_(1, idx, snap.to(leaf.device, leaf.dtype))
        return cache

