"""The Mamba language models (port of ``repro.models.mamba_lm``):
``family="mamba2"`` (SSD) and ``family="mamba"`` (Mamba-1, selective
scan).

Block = RMSNorm -> mixer -> residual; final RMSNorm; tied logits in
fp32.  Params are plain dicts of tensors with the layer trunk as a
per-layer list, walked by a Python loop.  :meth:`MambaLM.decode_view`
adds each mixer's kernel operands in fp32, once per weight set (the
engine serves from it).  The serving cache is the JAX package's stacked
layout, the family's state with a leading ``n_layers`` axis: mamba2's
``Mamba2State`` conv (L, b, w-1, dxbc) in the model dtype and ssm
(L, b, h, p, n) fp32; mamba1's ``Mamba1State`` conv (L, b, w-1, d_inner)
and ssm (L, b, d_inner, n) fp32.  Each step allocates the next cache once
and every layer's kernel writes its new state straight into its slice of
it.  The continuous engine's API (``prefill_chunk``, ``cache_batch_axes``,
``export_state`` / ``import_state``) addresses rows on batch axis 1 and
works on either family.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.base import ModelConfig
from repro_torch.nn import layers, ssm
from repro_torch.nn.params import stack_specs


# family -> the prefix of its mixer's functions in ``nn/ssm.py``
# (``<prefix>_specs``, ``_kernel_operands``, ``_apply``, ``_init_state``),
# looked up at call time.
_MIXERS = {"mamba2": "mamba2", "mamba": "mamba1"}


class MambaLM:
    """family == "mamba" (Mamba-1, selective scan) or "mamba2" (SSD);
    runs on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family not in _MIXERS:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; have "
                f"{sorted(_MIXERS)}")
        if not cfg.tie_embeddings:
            raise NotImplementedError("untied embeddings are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._prefix = _MIXERS[cfg.family]
        self._state = ssm.Mamba2State if cfg.family == "mamba2" else \
            ssm.Mamba1State

    def _fn(self, name: str):
        """The family's mixer function ``<prefix>_<name>`` of nn/ssm.py."""
        return getattr(ssm, f"{self._prefix}_{name}")

    def param_specs(self) -> dict:
        cfg = self.cfg
        block = {"ln": layers.norm_specs(cfg.d_model),
                 "mixer": self._fn("specs")(cfg)}
        return {
            "embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
            "final_norm": layers.norm_specs(cfg.d_model),
            "layers": stack_specs(block, cfg.n_layers),
        }

    def decode_view(self, params) -> dict:
        """``params`` with each layer's mixer carrying its kernel operands
        (``ssm.mamba{1,2}_kernel_operands``: fp32, ``A = -exp(A_log)``),
        so no step casts them again.  Build it once per weight set;
        ``prefill`` and ``decode_step`` take either form."""
        return dict(params, layers=[
            dict(p, mixer=dict(p["mixer"], kernel=self._fn(
                "kernel_operands")(p["mixer"]))) for p in params["layers"]])

    # ---------------- trunk ----------------
    def _trunk(self, params, x: torch.Tensor, cache
               ) -> Tuple[torch.Tensor, Any]:
        new = self._state(torch.empty_like(cache.conv),
                          torch.empty_like(cache.ssm))
        apply = self._fn("apply")
        for i, p in enumerate(params["layers"]):
            h, _ = apply(
                p["mixer"], self.cfg, layers.norm(p["ln"], x),
                self._state(cache.conv[i], cache.ssm[i]),
                out=self._state(new.conv[i], new.ssm[i]))
            x = x + h
        return x, new

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed(params["embed"],
                              layers.norm(params["final_norm"], x))

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits (b, l, V) fp32, no cache: every layer runs
        its prefill path without a carried state (the ablation's and the
        quality benchmark's entry point)."""
        x = layers.embed(params["embed"], tokens)
        for p in params["layers"]:
            h, _ = self._fn("apply")(p["mixer"], self.cfg,
                                     layers.norm(p["ln"], x))
            x = x + h
        return self._logits(params, x)

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_seq: int = 0,
                   dtype: torch.dtype = torch.bfloat16):
        """Zero state for ``batch`` rows (O(1) in ``max_seq``)."""
        del max_seq
        one = self._fn("init_state")(self.cfg, batch, dtype, self.device)
        n = self.cfg.n_layers
        return self._state(*(leaf.new_zeros((n,) + tuple(leaf.shape))
                             for leaf in one))

    def prefill(self, params, batch, cache) -> Tuple[torch.Tensor, Any]:
        """Whole prompt ``batch["tokens"]`` (b, l) -> (last logits (b, V)
        fp32, cache after the prompt)."""
        x = layers.embed(params["embed"], batch["tokens"])
        x, new_cache = self._trunk(params, x, cache)
        return self._logits(params, x[:, -1]), new_cache

    def prefill_chunk(self, params, tokens, cache, index
                      ) -> Tuple[torch.Tensor, Any]:
        """One prompt slice ``tokens`` (b, l) with carried state -> (last
        logits (b, V) fp32, cache).  ``index`` is accepted for API
        uniformity and ignored: the conv tail and SSM state carry position,
        so a chunk is the whole-sequence trunk re-entered with the previous
        chunk's state."""
        del index
        return self.prefill(params, {"tokens": tokens}, cache)

    def cache_batch_axes(self, cache):
        """Each cache leaf's batch axis: 1 behind the stacked layer axis."""
        return self._state(*(1 for _ in cache))

    def export_state(self, cache, index, rows):
        """Snapshot of ``rows``' state: fresh tensors (batch ``len(rows)``)
        on the cache's device, never views of ``cache``.  ``index`` (tokens
        consumed) is ignored: the state is O(1) in sequence length."""
        del index
        idx = torch.as_tensor(list(rows), device=cache.conv.device)
        return self._state(*(leaf.index_select(ax, idx) for leaf, ax in
                             zip(cache, self.cache_batch_axes(cache))))

    def import_state(self, cache, index, rows, snapshot):
        """Write snapshot row ``j`` into ``cache`` row ``rows[j]`` in place
        (the inverse of :meth:`export_state`); returns ``cache``."""
        del index
        idx = torch.as_tensor(list(rows), device=cache.conv.device)
        for leaf, snap, ax in zip(cache, snapshot,
                                  self.cache_batch_axes(cache)):
            leaf.index_copy_(ax, idx, snap.to(leaf.device, leaf.dtype))
        return cache

    def decode_step(self, params, token, cache, index) -> Tuple[torch.Tensor,
                                                                Any]:
        """token (b, 1) -> (logits (b, V) fp32, cache).  ``index`` is
        accepted for engine uniformity and ignored: the recurrence carries
        position in the state."""
        del index
        x = layers.embed(params["embed"], token)
        x, new_cache = self._trunk(params, x, cache)
        return self._logits(params, x[:, 0]), new_cache
