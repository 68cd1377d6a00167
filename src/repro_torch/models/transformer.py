"""Decoder-only transformer LM (port of
``repro.models.transformer.TransformerLM``): dense GQA / MQA, MoE and the
vision stub through config alone: gemma-2b (MQA, GeGLU, tied and scaled
embeddings), qwen1.5-4b (QKV biases, SwiGLU, an untied ``lm_head``),
deepseek-7b, internlm2-20b, qwen3-moe-30b-a3b and grok-1-314b (MoE
layers; grok with an attention soft-cap) and llava-next-mistral-7b (the
vision stub).

Each layer is norm -> attention (GQA / MQA, RoPE, causal, the config's
sliding window) -> residual, then norm -> gated MLP or MoE
(``nn/moe.py``, which also returns its load-balancing loss) ->
residual; then the
final norm and the logits in fp32: tied, ``x @ table^T`` accumulated in
fp32 (``nn/layers.py: unembed``); untied, ``x @ lm_head`` rounded to the
stream dtype and then widened, as the JAX package rounds them.  With
``embed_scale`` the embeddings are scaled by sqrt(d_model) cast to the
stream dtype first (in bf16 that is 45.25 for gemma-2b, not 45.255).
Under ``use_flash`` (a config override, as in the JAX package) the
whole-sequence attention of ``prefill`` and ``loss`` runs the flash
attention kernel (TPU kernel 9); chunked prefill and decode attend to the
cache with tensor code, as the JAX package does.

MoE: ``loss`` adds ``moe_aux_weight * aux / n_layers`` (``aux`` summed
over the layers) and reports ``metrics["moe_aux"]``; the serving calls
drop ``aux``.  An MoE row's output depends on every token of the call
(capacity and drops, ``nn/moe.py``), so a chunked prefill is not one
whole prefill and a verify window is not its steps: the engines call the
model on the JAX engines' own row sets.

The vision stub (``frontend="vision_stub"``): ``prefill`` and ``loss``
take ``batch["image_embeds"]`` (b, P, d), cast to the stream dtype and
put ahead of the token embeddings (``embed_scale`` scales the tokens
only); positions run over P + l and ``loss`` drops the first P logits.
The engines pass tokens only, so llava serves as text through them.

Params mirror the JAX tree (``embed``, ``final_norm``, the stacked
``layers``, ``lm_head`` when untied) so that a seed draws each leaf with
the JAX package's rule; the port walks the layers as a per-layer list.
The serving cache is one :class:`~repro_torch.nn.attention.KVCache` of
stacked k and v (n_layers, b, T, n_kv, head_dim) with ``T = min(max_seq,
sliding_window)``, the batch on axis 1, so the engines' row operations
work unchanged; each call allocates the next cache once and every layer
writes its slice of it.  Snapshots (``export_state``) keep the valid
prefix of a linear cache only (``nn/attention.py: snapshot_keep_len``).

Positions: ``prefill`` starts every row at 0; ``prefill_chunk`` and
``decode_step`` take ``index`` from the host (an int for the wave engine,
a ``(b,)`` array for the continuous engine's rows).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import base
from repro_torch.nn import attention, layers, mlp as mlp_mod, moe as moe_mod
from repro_torch.nn.params import stack_specs


class TransformerLM(base.DecodeAPI):
    """GQA / MQA transformer, dense or MoE; runs on ``device`` (default
    ``cuda``).  Of the frontends it reads only ``vision_stub``, as the JAX
    package's: under ``audio_stub`` it is a plain LM.  W8
    weights (``nn/quant.py``) go through ``layers.linear``'s ``qdot``
    (kernel 10 on the card), the ActiBA gated MLP under ``pallas()``
    through kernel 10's gated PWL form; the router and the bare expert
    tensors stay as they are, as the JAX package's ``quantize_params``
    leaves them."""

    def __init__(self, cfg: base.ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---------------- params ----------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        block = {
            "ln_attn": layers.norm_specs(cfg.d_model, norm_type=cfg.norm_type),
            "attn": attention.attention_specs(cfg),
            "ln_mlp": layers.norm_specs(cfg.d_model, norm_type=cfg.norm_type),
        }
        if cfg.moe:
            block["moe"] = moe_mod.moe_specs(cfg)
        else:
            block["mlp"] = mlp_mod.mlp_specs(cfg)
        specs = {
            "embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
            "final_norm": layers.norm_specs(cfg.d_model,
                                            norm_type=cfg.norm_type),
            "layers": stack_specs(block, cfg.n_layers),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = layers.linear_specs(
                cfg.d_model, cfg.vocab_size, axes=("embed", "vocab"))
        return specs

    def decode_view(self, params) -> dict:
        """``params`` as they are: no layer carries kernel operands."""
        return params

    # ---------------- trunk ----------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = base.embed_tokens(params, tokens, self.cfg)
        if self.cfg.embed_scale:
            # sqrt(d_model) rounded to the stream dtype first (np.sqrt
            # gives float64; the JAX package casts it to x's dtype).
            x = x * torch.tensor(np.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor, int]:
        """A whole-sequence call's (x, positions, P): the vision stub's
        ``image_embeds`` (b, P, d) ahead of the token embeddings, P = 0
        without them."""
        x = self._embed(params, batch["tokens"])
        prefix = 0
        if self.cfg.frontend == "vision_stub" and "image_embeds" in batch:
            img = batch["image_embeds"].to(x.device, x.dtype)
            x = torch.cat([img, x], dim=1)
            prefix = img.shape[1]
        return x, self._positions(np.arange(x.shape[1])[None, :]), prefix

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return base.lm_logits(params, layers.norm(
            params["final_norm"], x, norm_type=cfg.norm_type), cfg)

    def _trunk(self, params, x: torch.Tensor, positions: torch.Tensor,
               cache=None, cache_index=None
               ) -> Tuple[torch.Tensor, Any, Any]:
        """The layers in order -> (x, cache, the MoE aux loss summed over
        the layers: fp32, 0.0 for a dense model); with a cache, each layer
        writes its new k and v into its slice of one freshly allocated
        cache.  Without one (the training trunk) each layer runs under
        ``cfg.remat``."""
        new = None if cache is None else attention.KVCache(
            torch.empty_like(cache.k), torch.empty_like(cache.v))
        layer = self._layer if cache is not None else \
            base.remat(self._layer, self.cfg.remat)
        aux = 0.0                   # a tensor once an MoE layer adds to it
        for i, p in enumerate(params["layers"]):
            x, a = layer(i, p, x, positions, cache, new, cache_index)
            if a is not None:
                aux = aux + a
        return x, new, aux

    def _layer(self, i: int, p, x: torch.Tensor, positions: torch.Tensor,
               cache, new, cache_index):
        """Layer ``i``: attention and the MLP or MoE block -> (x, the MoE
        aux loss or ``None``)."""
        cfg = self.cfg
        h, _ = attention.apply(
            p["attn"], cfg,
            layers.norm(p["ln_attn"], x, norm_type=cfg.norm_type),
            positions=positions,
            cache=None if cache is None else
            attention.KVCache(cache.k[i], cache.v[i]),
            cache_index=cache_index, causal=True,
            window=cfg.sliding_window,
            out=None if cache is None else
            attention.KVCache(new.k[i], new.v[i]))
        x = x + h
        hin = layers.norm(p["ln_mlp"], x, norm_type=cfg.norm_type)
        if cfg.moe:
            h, a = moe_mod.apply(p["moe"], cfg, hin)
            return x + h, a
        return x + mlp_mod.apply(p["mlp"], cfg, hin), None

    def _positions(self, pos: np.ndarray) -> torch.Tensor:
        return torch.tensor(pos, dtype=torch.long, device=self.device)

    # ---------------- training ----------------
    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """The training loss (value and metrics): the cache-less trunk,
        each layer under ``cfg.remat`` (kernel 9 once a layer under
        ``use_flash``, through its ``torch.autograd.Function`` under grad),
        next-token cross entropy with the z-loss over the token positions
        (the vision stub's P image positions dropped), plus the MoE
        load-balancing term.  Inside the train step's split over
        ``model`` the embedding (scaled after the sum), the attention and
        MLP products, the logits and the loss run split
        (``nn/attention.py``, ``nn/mlp.py``, ``models/base.py``)."""
        cfg = self.cfg
        x, positions, prefix = self._embed_inputs(params, batch)
        x, _, aux = self._trunk(params, x, positions)
        logits = self._logits(params, x)
        if prefix:
            logits = base.positions_of(logits, slice(prefix, None))
        loss, metrics = base.cross_entropy_loss(
            base.positions_of(logits, slice(-1)), batch["labels"][:, 1:])
        if cfg.moe:
            loss = loss + cfg.moe_aux_weight * aux / cfg.n_layers
            metrics["moe_aux"] = aux / cfg.n_layers
        metrics["loss_total"] = loss
        return loss, metrics

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> attention.KVCache:
        """Zero KV cache for ``batch`` rows whose prompt and continuation
        fit in ``max_seq`` positions: a ring of ``sliding_window`` slots
        when the window fits, else linear."""
        cfg = self.cfg
        T = min(max_seq, cfg.sliding_window or max_seq)
        shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.head_dim)
        return attention.KVCache(
            torch.zeros(shape, dtype=dtype, device=self.device),
            torch.zeros(shape, dtype=dtype, device=self.device))

    def cache_batch_axes(self, cache):
        """Each cache leaf's batch axis: 1 behind the stacked layer axis."""
        return attention.KVCache(1, 1)

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """Whole prompt ``batch["tokens"]`` (b, l), every row from
        position 0, behind ``batch["image_embeds"]`` (b, P, d) under the
        vision stub -> (last logits (b, V) fp32, cache after the P + l
        positions)."""
        x, positions, _ = self._embed_inputs(params, batch)
        x, new, _ = self._trunk(params, x, positions, cache)
        return self._logits(params, x[:, -1]), new

    def _chunk_hidden(self, params, tokens, cache, index):
        """A chunk whose first token sits at ``index`` (int or per row):
        each layer appends the chunk's k / v at ``index .. index + l - 1``
        and attends to the cached prefix (``nn/attention.py:
        chunk_attention``)."""
        idx = np.asarray(index, np.int64)
        pos = base.chunk_positions(idx, *tokens.shape)
        x, new, _ = self._trunk(params, self._embed(params, tokens),
                                self._positions(pos), cache, idx)
        return x, new

    def decode_step(self, params, token, cache, index
                    ) -> Tuple[torch.Tensor, Any]:
        """token (b, 1) at position ``index`` (int or per row) -> (logits
        (b, V) fp32, cache)."""
        idx = np.asarray(index, np.int64)
        b = token.shape[0]
        pos = np.broadcast_to(idx.reshape(-1, 1), (b, 1))
        x = self._embed(params, token)
        x, new, _ = self._trunk(params, x, self._positions(pos), cache,
                                idx)
        return self._logits(params, x[:, 0]), new

    def export_state(self, cache, index, rows):
        """Snapshot of ``rows``' KV after ``index`` consumed tokens: fresh
        tensors (batch ``len(rows)``) on the cache's device, never views
        of ``cache``, a linear cache clipped to its first ``index``
        positions (``index=None`` keeps them all; a ring stays whole)."""
        idx = torch.as_tensor(list(rows), device=cache.k.device)
        keep = attention.snapshot_keep_len(cache.k.shape[2], index,
                                           self.cfg.sliding_window)
        return attention.KVCache(*(leaf[:, :, :keep].index_select(1, idx)
                                   for leaf in cache))

    def import_state(self, cache, index, rows, snapshot):
        """Write snapshot row ``j`` into ``cache`` row ``rows[j]`` in place,
        zeros past a clipped snapshot's positions (the inverse of
        :meth:`export_state`); returns ``cache``."""
        del index
        idx = torch.as_tensor(list(rows), device=cache.k.device)
        for leaf, snap in zip(cache, snapshot):
            full = leaf.new_zeros(snap.shape[:2] + leaf.shape[2:])
            full[:, :, :snap.shape[2]] = snap.to(leaf.device, leaf.dtype)
            leaf.index_copy_(1, idx, full)
        return cache
