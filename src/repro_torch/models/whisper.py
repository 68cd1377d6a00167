"""Whisper-style encoder-decoder transformer (port of
``repro.models.whisper.Whisper``), the audio frontend a stub: a batch
carries precomputed frame embeddings ``frames`` (b, encoder_seq,
d_model) beside its ``tokens``.

The encoder adds sinusoidal positions to the frames and runs
bidirectional layers (LayerNorm -> attention, not causal -> residual;
LayerNorm -> the plain GeLU MLP -> residual), then a final LayerNorm.
Each decoder layer runs causal self-attention, cross-attention to the
encoder's output and the MLP, each behind its LayerNorm; the decoder
embeds its tokens with sinusoidal positions at their absolute offsets,
and its logits are the final LayerNorm and the tied unembedding in fp32.
As in the JAX package, self-attention keeps RoPE besides the
sinusoids, and ``loss`` takes no remat; its ``shard_tokens3d`` sharding
hints are the identity on one card.

Under ``use_flash`` every whole-sequence attention runs the flash
attention kernel (TPU kernel 9): the encoder's (1500 keys, not causal),
the decoder's self-attention in ``prefill`` and ``loss`` (causal) and
its cross-attention in ``prefill``, ``prefill_chunk`` and ``loss`` (the
prompt's queries against the frames' keys, not causal).  A chunk's
self-attention and every decode step attend to the cache with tensor
code.  W8 weights go through ``layers.linear``'s ``qdot`` (kernel 10 on
the card) in every projection; the tied table stays as it is.  ActiBA
reaches kernel 12 in the MLP's GeLU.

The serving cache is a list with one ``{"self", "cross"}`` pair of
:class:`~repro_torch.nn.attention.KVCache` a decoder layer, batch on
axis 0: ``self`` of ``max_seq`` positions, ``cross`` of
``encoder_seq``.  ``prefill`` and every ``prefill_chunk`` call encode the
frames and rewrite the cross cache whole (the JAX package's stub
frontend is cheap, so it does not keep the encoding between chunks);
``decode_step`` reads it.  Snapshots (``export_state``) keep whole rows:
the JAX package's default clips nothing for whisper.

The JAX package does not serve whisper through its token-only engines,
and neither does the port: they refuse it (``serve/engine.py``).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import base
from repro_torch.nn import attention, layers, mlp as mlp_mod


def _ln(p, x):
    return layers.norm(p, x, norm_type="layernorm")


class Whisper(base.DecodeAPI):
    """Encoder-decoder on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: base.ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_enc = cfg.encoder_layers or cfg.n_layers
        self.n_dec = cfg.n_layers

    # ---------------- params ----------------
    def param_specs(self) -> dict:
        cfg = self.cfg

        def ln():
            return layers.norm_specs(cfg.d_model, norm_type="layernorm")
        enc_block = {"ln_attn": ln(), "attn": attention.attention_specs(cfg),
                     "ln_mlp": ln(), "mlp": mlp_mod.mlp_specs(cfg)}
        dec_block = {"ln_self": ln(),
                     "self_attn": attention.attention_specs(cfg),
                     "ln_cross": ln(),
                     "cross_attn": attention.attention_specs(cfg),
                     "ln_mlp": ln(), "mlp": mlp_mod.mlp_specs(cfg)}
        return {
            "embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
            "enc_ln_post": ln(),
            "dec_ln_post": ln(),
            "encoder": {str(i): enc_block for i in range(self.n_enc)},
            "decoder": {str(i): dec_block for i in range(self.n_dec)},
        }

    # ---------------- encoder ----------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames (b, L, d_model), the stub frontend's output -> the
        encoder's output (b, L, d_model) in the frames' dtype."""
        cfg = self.cfg
        L = frames.shape[1]
        x = frames + layers.sinusoidal_positions(
            L, cfg.d_model, device=frames.device).to(frames.dtype)[None]
        positions = torch.arange(L, device=frames.device)[None, :]
        for p in params["encoder"]:
            h, _ = attention.apply(p["attn"], cfg, _ln(p["ln_attn"], x),
                                   positions=positions, causal=False)
            x = x + h
            x = x + mlp_mod.apply(p["mlp"], cfg, _ln(p["ln_mlp"], x))
        return _ln(params["enc_ln_post"], x)

    # ---------------- decoder ----------------
    def _dec_trunk(self, params, x, positions, enc_out, caches=None,
                   cache_index=None) -> Tuple[torch.Tensor, List[Any]]:
        """The decoder layers; with ``caches`` each returns its new
        ``{"self", "cross"}`` pair (``enc_out`` None: the decode step,
        reading the cross cache)."""
        cfg = self.cfg
        new: List[Any] = []
        for i, p in enumerate(params["decoder"]):
            cache = None if caches is None else caches[i]
            h, nsc = attention.apply(
                p["self_attn"], cfg, _ln(p["ln_self"], x),
                positions=positions,
                cache=None if cache is None else cache["self"],
                cache_index=cache_index, causal=True)
            x = x + h
            h, ncc = attention.apply(
                p["cross_attn"], cfg, _ln(p["ln_cross"], x),
                positions=positions,
                cache=None if cache is None else cache["cross"],
                cache_index=cache_index, kv_source=enc_out, is_cross=True)
            x = x + h
            x = x + mlp_mod.apply(p["mlp"], cfg, _ln(p["ln_mlp"], x))
            new.append(None if cache is None else {"self": nsc, "cross": ncc})
        return x, new

    def _dec_embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(params["embed"], tokens)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed(params["embed"], _ln(params["dec_ln_post"], x))

    def _positions(self, pos: np.ndarray) -> torch.Tensor:
        return torch.tensor(pos, dtype=torch.long, device=self.device)

    def _whole(self, params, batch, caches=None):
        """A whole decoder sequence from position 0 behind the encoded
        ``batch["frames"]`` -> (hidden states, caches)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        x = self._dec_embed(params, tokens) + layers.sinusoidal_positions(
            tokens.shape[1], cfg.d_model,
            device=tokens.device).to(cfg.dtype)[None]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return self._dec_trunk(params, x, positions, enc_out, caches)

    # ---------------- training ----------------
    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """Next-token cross entropy with the z-loss over ``batch["tokens"]``
        (b, l) behind ``batch["frames"]``; ``labels`` (b, l) shifted as in
        the JAX package."""
        x, _ = self._whole(params, batch)
        loss, metrics = base.cross_entropy_loss(
            self._logits(params, x)[:, :-1], batch["labels"][:, 1:])
        metrics["loss_total"] = loss
        return loss, metrics

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> List[dict]:
        cfg = self.cfg
        return [{"self": attention.init_cache(cfg, batch, max_seq, dtype,
                                              self.device),
                 "cross": attention.init_cache(cfg, batch, cfg.encoder_seq,
                                               dtype, self.device)}
                for _ in range(self.n_dec)]

    def cache_batch_axes(self, cache):
        """Every leaf's batch axis: 0."""
        return [{k: attention.KVCache(0, 0) for k in c} for c in cache]

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """``{"tokens": (b, l), "frames": (b, L, d)}``, every row from
        position 0 -> (last logits (b, V) fp32, cache)."""
        x, new = self._whole(params, batch, cache)
        return self._logits(params, x[:, -1]), new

    def prefill_chunk(self, params, batch, cache, index
                      ) -> Tuple[torch.Tensor, Any]:
        """One slice ``batch["tokens"]`` (b, s) of the decoder prompt, its
        first token at ``index`` (int or per row), behind
        ``batch["frames"]``: the frames are encoded again and the cross
        cache rewritten; self-attention appends at ``index``."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        idx = np.asarray(index, np.int64)
        positions = self._positions(base.chunk_positions(idx, *tokens.shape))
        x = self._dec_embed(params, tokens) + layers.sinusoidal_positions_at(
            positions, cfg.d_model).to(cfg.dtype)
        x, new = self._dec_trunk(params, x, positions, enc_out, cache, idx)
        return self._logits(params, x[:, -1]), new

    def decode_step(self, params, token, cache, index
                    ) -> Tuple[torch.Tensor, Any]:
        """token (b, 1) at position ``index`` (an int: every row at one
        position, as the JAX package's whisper takes it) -> (logits (b, V)
        fp32, cache)."""
        cfg = self.cfg
        positions = self._positions(np.full((token.shape[0], 1), int(index)))
        x = self._dec_embed(params, token) + layers.sinusoidal_position_at(
            positions[0, 0], cfg.d_model).to(cfg.dtype)[None, None, :]
        x, new = self._dec_trunk(params, x, positions, None, cache,
                                 int(index))
        return self._logits(params, x[:, 0]), new

    def export_state(self, cache, index, rows):
        """Snapshot of ``rows`` (whole rows whatever ``index``): fresh
        tensors (batch ``len(rows)``) on the cache's device."""
        del index
        idx = torch.as_tensor(list(rows), device=cache[0]["self"].k.device)
        return [{k: attention.KVCache(*(leaf.index_select(0, idx)
                                        for leaf in kv))
                 for k, kv in c.items()} for c in cache]

    def import_state(self, cache, index, rows, snapshot):
        """Write snapshot row ``j`` into ``cache`` row ``rows[j]`` in place
        (the inverse of :meth:`export_state`); returns ``cache``."""
        del index
        idx = torch.as_tensor(list(rows), device=cache[0]["self"].k.device)
        for c, snap in zip(cache, snapshot):
            for k in c:
                for leaf, s in zip(c[k], snap[k]):
                    leaf.index_copy_(0, idx, s.to(leaf.device, leaf.dtype))
        return cache
