"""Model configuration: the ``repro.models.base.ModelConfig`` fields that
the Mamba-1, Mamba-2, RecurrentGemma, transformer (dense, MoE and the
vision stub) and Whisper families use,
with ``dtype`` as a ``torch.dtype``; the shared helpers
``chunk_positions``, ``cross_entropy_loss`` and ``remat`` (the
training trunk's per-layer rematerialization); and :class:`DecodeAPI`,
the serving surface's shared part (``prefill_chunk`` and
``verify_chunk`` over each family's chunk trunk, and the reference
``speculative_step``) that the model classes inherit."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.xamba import XambaConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def chunk_positions(index, batch: int, seq: int) -> np.ndarray:
    """(b, s) absolute positions (int64, on the host) of a prefill chunk
    whose first token sits at ``index`` (an int or ``(b,)``)."""
    idx = np.asarray(index, np.int64)
    if idx.ndim == 0:
        idx = np.full((batch,), idx, np.int64)
    return idx[:, None] + np.arange(seq, dtype=np.int64)[None, :]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4) -> Tuple[torch.Tensor, dict]:
    """Token-level CE with the z-loss; labels < 0, and positions where
    ``mask`` is not > 0, are ignored (the JAX package's
    ``cross_entropy_loss``)."""
    logits = logits.float()
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    labels_safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse.square()
    denom = valid.sum().clamp_min(1)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    loss = torch.where(valid, nll, zero).sum() / denom
    hit = (logits.argmax(-1) == labels_safe).to(logits.dtype)
    acc = torch.where(valid, hit, zero).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


# The matrix products without batch dims whose outputs ``remat="dots"``
# keeps (JAX's ``dots_with_no_batch_dims_saveable``); everything else in
# a layer is recomputed in the backward.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def remat(fn, mode: str):
    """``fn`` (one layer of a training trunk) under ``ModelConfig.remat``:
    ``"none"`` as it is; ``"full"`` keeps only its inputs and recomputes
    the layer in the backward (``jax.checkpoint`` with no policy);
    ``"dots"`` keeps the outputs of its matrix products without batch
    dims and recomputes the rest.  With grad disabled it runs ``fn`` as
    it is: nothing is kept then."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"remat {mode!r} not in ('none', 'full', 'dots')")
    kw = {} if mode == "full" else {"context_fn": _dots_context}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return run


def _host_tokens(tokens) -> np.ndarray:
    """Token ids (a tensor on any device, or an array) as flat int64."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return np.asarray(tokens, np.int64).reshape(-1)


def _greedy(logits: torch.Tensor) -> np.ndarray:
    return np.argmax(logits.float().cpu().numpy(), axis=-1).astype(np.int64)


class DecodeAPI:
    """What every served family shares beyond its own ``prefill``,
    ``_chunk_hidden``, ``_logits``, ``decode_step`` and ``export_state`` /
    ``import_state`` (the JAX package's ``DecodeAPI``)."""

    def _chunk_hidden(self, params, tokens, cache, index):
        """The family's chunk trunk: ``tokens`` (b, l), the first at
        ``index`` (int or per row), through every layer with carried
        state -> (final hidden states (b, l, d), cache)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement _chunk_hidden")

    def prefill_chunk(self, params, tokens, cache, index):
        """One prompt slice ``tokens`` (b, l) with carried state, its first
        token at ``index`` (int or per row) -> (last logits (b, V) fp32,
        cache)."""
        x, new = self._chunk_hidden(params, tokens, cache, index)
        return self._logits(params, x[:, -1]), new

    def verify_chunk(self, params, tokens, cache, index):
        """:meth:`prefill_chunk` with per-position logits: ``(b, s, V)``
        fp32 instead of the last position's, so that one batched call
        scores every token of a speculative draft window against the
        full-precision stream (``serve/speculative.py``).  The same trunk,
        so the carried state and KV writes are those of
        ``prefill_chunk``."""
        x, new = self._chunk_hidden(params, tokens, cache, index)
        return self._logits(params, x), new

    def speculative_step(self, params_draft, params_verify, token, cache,
                         index, k: int):
        """One self-speculative burst, host-driven (the reference the
        continuous engine's burst must match; the accept rule is in
        ``serve/speculative.py``): draft ``k`` greedy tokens with
        ``params_draft`` from ``cache``, verify them in one
        ``verify_chunk`` call with ``params_verify``, emit the longest
        verified prefix plus one correction token, and repair rows that
        consumed a rejected draft by re-advancing their pre-burst
        snapshot through ``decode_step``.

        ``token``: ``(b, 1)`` pending next-input tokens; ``index``: an
        int or ``(b,)`` consumed-token counts.  Returns ``(emitted,
        n_emit, cache, new_index)``: ``emitted`` is ``(b, k)`` int64 with
        only the first ``n_emit[i]`` entries of row ``i`` meaningful, and
        ``new_index = index + n_emit``.  Every entry point allocates the
        cache it returns, so the caller's ``cache`` stays valid."""
        from repro_torch.serve.speculative import accept_lengths, \
            emit_counts, needs_rollback
        if k < 1:
            raise ValueError(f"speculative_step needs k >= 1, got {k}")
        tok0 = _host_tokens(token)
        b = tok0.shape[0]
        idx = np.asarray(index, np.int64)
        if idx.ndim == 0:
            idx = np.full((b,), idx, np.int64)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        # Draft pass: decode_step writes a new cache, so ``cache`` itself
        # survives as the pre-burst snapshot.
        dcache, cur = cache, tok0
        drafts = np.zeros((b, k), np.int64)
        for j in range(k):
            logits, dcache = self.decode_step(params_draft, dev(cur[:, None]),
                                              dcache, idx + j)
            cur = drafts[:, j] = _greedy(logits)

        # Verify pass: one chunk over [t0, d_1 .. d_{k-1}].
        vtoks = np.concatenate([tok0[:, None], drafts[:, :k - 1]], axis=1)
        vlogits, vcache = self.verify_chunk(params_verify, dev(vtoks), cache,
                                            idx)
        verify = _greedy(vlogits)

        m = accept_lengths(drafts, verify)
        n_emit = emit_counts(m, k).astype(np.int64)
        # Rolled-back rows: re-advance the pre-burst row over the tokens
        # the emitted stream consumed, [t0, g_0 .. g_{n-2}], through the
        # full-precision step: exactly the non-speculative trajectory.
        for i in np.nonzero(needs_rollback(m, k))[0]:
            rcache = self.export_state(cache, None, [int(i)])
            consume = [int(tok0[i])] + [int(t) for t in
                                        verify[i, :int(n_emit[i]) - 1]]
            for j, t in enumerate(consume):
                _, rcache = self.decode_step(
                    params_verify, dev(np.array([[t]], np.int64)), rcache,
                    int(idx[i]) + j)
            vcache = self.import_state(
                vcache, None, [int(i)], self.export_state(rcache, None, [0]))
        return verify, n_emit, vcache, idx + n_emit


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The subset of the JAX package's one-config-for-all-families that the
    ported families read."""

    name: str = "model"
    family: str = "mamba2"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    tie_embeddings: bool = True

    # -- attention (the transformer; recurrentgemma's local attention) --------
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    attn_probs_bf16: bool = False  # cast softmax probs to bf16 before PV

    # -- mlp ------------------------------------------------------------------
    d_ff: int = 2048
    mlp_type: str = "swiglu"      # swiglu | geglu | mlp

    # -- norms / embeddings ---------------------------------------------------
    norm_type: str = "rmsnorm"    # rmsnorm | gemma_rmsnorm | layernorm
    embed_scale: bool = False     # gemma: x *= sqrt(d_model)

    # -- SSM (mamba / mamba2) -------------------------------------------------
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    chunk_size: int = 256
    dt_rank: int = 0              # 0 -> ceil(d_model/16) (mamba1)
    # mamba1 prefill: core/selective_scan.py mode (associative | sequential
    # | chunked).
    scan_mode: str = "associative"
    ssd_dtype: str = "float32"    # SSD big-matmul dtype (bf16 = perf mode)

    # -- recurrentgemma -------------------------------------------------------
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ()   # e.g. ("recurrent", "recurrent",
    #                                       "attention")

    # -- MoE (the transformer's mixture-of-experts layers, nn/moe.py) --------
    moe: bool = False
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_renormalize: bool = True
    moe_aux_weight: float = 0.01
    # The JAX package's sharding hint for the dispatch buffers, kept as a
    # name only: one card has no mesh to pin them to.
    moe_cap_batch_sharding: bool = False

    # -- multimodal stubs -----------------------------------------------------
    # vision_stub (llava) puts image embeddings ahead of the tokens; the
    # transformer reads nothing else.  Whisper's config sets no frontend:
    # its stub is the precomputed frames its batches carry.
    frontend: Optional[str] = None        # vision_stub | audio_stub
    num_patches: int = 0                  # llava: image token count
    encoder_layers: int = 0               # whisper (0: n_layers)
    encoder_seq: int = 1500               # whisper frame count

    # -- execution policies ---------------------------------------------------
    param_dtype: str = "bfloat16"
    # Rematerialization of the training trunk's layers (``remat``: none |
    # full | dots).  The port always walks its layers in a Python loop;
    # ``scan_layers`` names the JAX package's layout of the stacked trunk,
    # which its checkpoints keep (``nn/params.py: to_jax_params``).
    remat: str = "none"
    scan_layers: bool = True
    # Whole-sequence attention without a logit soft-cap runs the flash
    # attention kernel (TPU kernel 9; ``nn/attention.py: full_attention``).
    use_flash: bool = False
    # Kept as a name only: the device decides what runs (the kernel on a
    # CUDA tensor, its plain version on a CPU one), as with the
    # ``pallas_interpret`` modes.
    flash_interpret: bool = False
    # A one-token call with a state takes the prefill path, not the step.
    force_prefill_path: bool = False
    xamba: XambaConfig = XambaConfig()

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_decode_mode(self, mode: str) -> "ModelConfig":
        """Config with ``XambaConfig.decode`` overridden (CLI plumbing)."""
        return self.replace(xamba=dataclasses.replace(self.xamba,
                                                      decode=mode))

    def with_prefill_mode(self, mode: str) -> "ModelConfig":
        """Config with ``XambaConfig.prefill`` overridden (CLI plumbing)."""
        return self.replace(xamba=dataclasses.replace(self.xamba,
                                                      prefill=mode))

    def with_quant(self, mode: str) -> "ModelConfig":
        """Config with ``XambaConfig.quant`` overridden (CLI plumbing)."""
        return self.replace(xamba=dataclasses.replace(self.xamba,
                                                      quant=mode))
