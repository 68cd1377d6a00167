"""Multi-head attention (GQA/MQA) with a KV cache, RoPE and a sliding
window: a port of ``repro.nn.attention`` in plain PyTorch ops.

Scores and softmax in fp32, masks of ``-1e30``, the soft-cap on the
scores before masking, as tensor code, except where the JAX package
takes its Pallas kernel: ``full_attention`` (the cache-less forward and
the whole-prompt prefill) with ``use_flash`` and no logit soft-cap runs
the flash-attention kernel (TPU kernel 9, ``kernels/ops.py:
flash_attention``; its plain version on a CPU tensor), ahead of the
blocked form, as the JAX package orders them.  The kernel's masks are
left-aligned, the tensor path's right-aligned: they agree for
self-attention (as many queries as keys), the only caller.

Layouts are the JAX package's: q (b, s, nq, hd), k / v (b, t, nkv, hd),
caches (b, T, nkv, hd).  Two cache layouts: **linear** (position p in
slot p) and **ring** (``T == window``: position p in slot p % T).

Positions: ``cache_index`` / ``offset`` come from the host (an int, or a
``(b,)`` numpy array or list), as the engines keep them; a write to a
slot past the cache is dropped, as the JAX package's scatters drop it.
The host copy only decides that; the slots and masks are computed on
the device from the RoPE positions the model already moved there
(``positions`` / ``q_pos``), because every copy of a CPU tensor to the
card waits for the stream to drain.  Every function returns new cache
tensors and leaves its input cache as it was; ``out`` (a
:class:`KVCache` of buffers apart from the input) receives them instead
of fresh tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.nn import layers

NEG_INF = -1e30
# Above this many kv positions the whole-sequence path switches to the
# blocked online-softmax form (the JAX package's thresholds).
BLOCKED_ATTN_THRESHOLD = 2048
BLOCKED_ATTN_KV_BLOCK = 1024


class KVCache(NamedTuple):
    k: torch.Tensor  # (b, T, n_kv, head_dim)
    v: torch.Tensor  # (b, T, n_kv, head_dim)


def attention_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": layers.linear_specs(d, nq * hd, bias=cfg.qkv_bias),
        "wk": layers.linear_specs(d, nkv * hd, bias=cfg.qkv_bias),
        "wv": layers.linear_specs(d, nkv * hd, bias=cfg.qkv_bias),
        "wo": layers.linear_specs(nq * hd, d),
    }


def init_cache(cfg, batch: int, max_seq: int, dtype: torch.dtype,
               device) -> KVCache:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _host_rows(index, b: int) -> np.ndarray:
    """A host-side position (an int, or per row) as int64 ``(b,)``."""
    if isinstance(index, torch.Tensor):
        index = index.cpu().numpy()
    idx = np.asarray(index, np.int64)
    return np.full((b,), idx, np.int64) if idx.ndim == 0 else idx


def _grouped_q(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """q scaled by hd^-0.5 in fp32 as (b, s, nkv, q-per-group, hd): the
    grouped einsums keep k and v unreplicated."""
    b, s, nq, hd = q.shape
    return (q.float() * hd ** -0.5).reshape(b, s, nkv, nq // nkv, hd)


def _scores(qg: torch.Tensor, keys: torch.Tensor,
            logit_softcap: Optional[float]) -> torch.Tensor:
    """(b, g, q, s, t) fp32 scores, soft-capped."""
    sc = torch.einsum("bsgqd,btgd->bgqst", qg, keys.float())
    if logit_softcap is not None:
        sc = torch.tanh(sc / logit_softcap) * logit_softcap
    return sc


def _pv(p: torch.Tensor, vals: torch.Tensor, probs_bf16: bool
        ) -> torch.Tensor:
    """(b, s, g, q, hd) = p @ v in fp32; ``probs_bf16`` rounds both
    operands to bf16 first (their products and sums stay fp32)."""
    if probs_bf16:
        p, vals = p.to(torch.bfloat16), vals.to(torch.bfloat16)
    return torch.einsum("bgqst,btgd->bsgqd", p.float(), vals.float())


def _targets(cache: KVCache, out: Optional[KVCache]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensors a call writes its new cache into: ``out`` holding a
    copy of ``cache``, else clones."""
    if out is None:
        return cache.k.clone(), cache.v.clone()
    for o, c in zip(out, cache):
        if o.data_ptr() == c.data_ptr():
            raise ValueError("attention: out must not be the input cache")
        o.copy_(c)
    return out.k, out.v


def _scatter_rows(dst: torch.Tensor, cols: np.ndarray,
                  cols_dev: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[r, cols[r, j]] = src[r, j]``, dropping columns outside
    ``[0, T)`` (the JAX package's scatter semantics): ``cols`` (b, s) on
    the host decides, ``cols_dev`` (the same on the device) indexes."""
    T = dst.shape[1]
    ok = (cols >= 0) & (cols < T)
    dev = dst.device
    src = src.to(dst.dtype)
    if ok.all():
        rows = torch.arange(cols.shape[0], device=dev)[:, None]
        dst[rows, cols_dev] = src
        return
    r, j = np.nonzero(ok)
    if r.size:
        rt = torch.from_numpy(r).to(dev)
        dst[rt, torch.from_numpy(cols[r, j]).to(dev)] = \
            src[rt, torch.from_numpy(j).to(dev)]


def _on_device(index, b: int, dev) -> torch.Tensor:
    """A position (an int, per row on the host, or a tensor) as a (b,)
    tensor on ``dev``; a host value costs a copy that waits for the
    stream."""
    if isinstance(index, torch.Tensor):
        return index.to(dev).expand(b)
    return torch.from_numpy(_host_rows(index, b)).to(dev)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int],
                      logit_softcap: Optional[float] = None,
                      block_k: int = BLOCKED_ATTN_KV_BLOCK,
                      probs_bf16: bool = False) -> torch.Tensor:
    """Online-softmax attention over kv blocks of ``block_k``: the score
    matrix never exists whole.  q (b, s, nq, hd); k, v (b, t, nkv, hd);
    queries right-aligned to the keys."""
    b, s, nq, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qpg = nq // nkv
    dev = q.device
    pad_t = (-t) % block_k
    if pad_t:
        zeros = k.new_zeros((b, pad_t, nkv, hd))
        k, v = torch.cat([k, zeros], 1), torch.cat([v, zeros], 1)
    qg = _grouped_q(q, nkv)
    q_ids = torch.arange(s, device=dev)[:, None] + (t - s)
    m = torch.full((b, nkv, qpg, s), NEG_INF, device=dev)
    l = torch.zeros((b, nkv, qpg, s), device=dev)
    acc = torch.zeros((b, nkv, qpg, s, hd), device=dev)
    for kv0 in range(0, t + pad_t, block_k):
        sc = _scores(qg, k[:, kv0:kv0 + block_k], logit_softcap)
        k_ids = kv0 + torch.arange(block_k, device=dev)[None, :]
        mask = (k_ids < t).expand(s, block_k)
        if causal:
            mask = mask & (k_ids <= q_ids)
        if window is not None:
            mask = mask & (k_ids > q_ids - window)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        contrib = _pv(p, v[:, kv0:kv0 + block_k], probs_bf16)
        acc = acc * alpha[..., None] + contrib.permute(0, 2, 3, 1, 4)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]               # (b,g,q,s,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nq, hd).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   use_flash: bool = False,
                   logit_softcap: Optional[float] = None,
                   probs_bf16: bool = False) -> torch.Tensor:
    """q (b, s, nq, hd); k, v (b, t, nkv, hd) -> (b, s, nq, hd)."""
    if use_flash and logit_softcap is None:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
        return out.transpose(1, 2)
    if k.shape[1] > BLOCKED_ATTN_THRESHOLD:
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 logit_softcap=logit_softcap,
                                 probs_bf16=probs_bf16)
    sc = _scores(_grouped_q(q, k.shape[2]), k, logit_softcap)
    sl, tl = sc.shape[-2], sc.shape[-1]
    dev = q.device
    q_ids = torch.arange(sl, device=dev)[:, None] + (tl - sl)
    k_ids = torch.arange(tl, device=dev)[None, :]
    mask = torch.ones((sl, tl), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_ids <= q_ids)
    if window is not None:
        mask = mask & (k_ids > q_ids - window)
    p = torch.softmax(torch.where(mask, sc, NEG_INF), dim=-1)
    out = _pv(p, v, False)
    return out.reshape(q.shape).to(q.dtype)


def decode_attention(q: torch.Tensor, cache: KVCache, cache_len, *,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """One query position against the cache.  q (b, 1, nq, hd);
    ``cache_len``: valid positions, an int, or per row (on the host or
    the device); the new token's k / v already written."""
    b = q.shape[0]
    T = cache.k.shape[1]
    sc = _scores(_grouped_q(q, cache.k.shape[2]), cache.k, logit_softcap)
    cl = cache_len if isinstance(cache_len, int) else \
        _on_device(cache_len, b, q.device)[:, None]
    k_ids = torch.arange(T, device=q.device)[None, :]
    valid = k_ids < cl
    if window is not None:
        valid = valid & (k_ids > cl - 1 - window)
    p = torch.softmax(torch.where(valid[:, None, None, None, :], sc,
                                  NEG_INF), dim=-1)
    out = _pv(p, cache.v, False)
    return out.reshape(q.shape).to(q.dtype)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache: KVCache, offset, *,
                    window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    probs_bf16: bool = False,
                    out: Optional[KVCache] = None,
                    q_pos: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Chunked-prefill attention: append the chunk's k / v at per-row
    ``offset`` and attend its queries to everything cached so far.

    q, k, v (b, s, n, hd), already RoPE'd at their absolute positions;
    ``offset``: the tokens each row has consumed (on the host);
    ``q_pos``: the queries' absolute positions (b, s) on the device, if
    the caller has them.  Linear layout: scatter at ``offset + j`` and
    mask by absolute position.  Ring layout (``T == window``): attend
    over [ring before the write ; chunk] with each slot's absolute
    position, then rewrite the ring with the last ``T`` positions."""
    b, s, _, _ = q.shape
    T = cache.k.shape[1]
    dev = q.device
    off = _host_rows(offset, b)
    if q_pos is None:
        q_pos = _on_device(off, b, dev)[:, None] + \
            torch.arange(s, device=dev)[None, :]
    q_pos = q_pos.expand(b, s)
    off_t = q_pos[:, 0]
    qg = _grouped_q(q, cache.k.shape[2])
    ck, cv = _targets(cache, out)
    ring = window is not None and T == window

    if not ring:
        cols = off[:, None] + np.arange(s, dtype=np.int64)[None, :]
        _scatter_rows(ck, cols, q_pos, k)
        _scatter_rows(cv, cols, q_pos, v)
        sc = _scores(qg, ck, logit_softcap)                 # (b,g,q,s,T)
        k_ids = torch.arange(T, device=dev)[None, None, :]
        valid = k_ids <= q_pos[..., None]                   # (b, s, T)
        if window is not None:
            valid = valid & (k_ids > q_pos[..., None] - window)
        p = torch.softmax(torch.where(valid[:, None, None], sc, NEG_INF),
                          dim=-1)
        o = _pv(p, cv, probs_bf16)
        return o.reshape(q.shape).to(q.dtype), KVCache(ck, cv)

    slots = torch.arange(T, device=dev)[None, :]
    last = off_t[:, None] - 1
    # The absolute position each slot holds before the write: the largest
    # p < offset with p = slot (mod T); negative = never written.
    ring_pos = last - torch.remainder(last - slots, T)      # (b, T)
    valid_ring = (ring_pos[:, None, :] >= 0) & \
        (ring_pos[:, None, :] > q_pos[..., None] - window)  # (b, s, T)
    i_ids = torch.arange(s, device=dev)[:, None]
    j_ids = torch.arange(s, device=dev)[None, :]
    valid_chunk = (j_ids <= i_ids) & (j_ids > i_ids - window)
    sc = torch.cat([
        torch.where(valid_ring[:, None, None],
                    _scores(qg, cache.k, logit_softcap), NEG_INF),
        torch.where(valid_chunk, _scores(qg, k, logit_softcap), NEG_INF)],
        dim=-1)
    p = torch.softmax(sc, dim=-1)
    o = _pv(p, torch.cat([cache.v.float(), v.float()], dim=1), False)
    # Rewrite the ring with the last T positions <= offset + s - 1.
    new_last = off_t[:, None] + s - 1
    src = new_last - torch.remainder(new_last - slots, T) - off_t[:, None]
    take = (src >= 0)[..., None, None]
    rows = torch.arange(b, device=dev)[:, None]
    src_c = src.clamp(0, s - 1)
    ck.copy_(torch.where(take, k[rows, src_c].to(ck.dtype), cache.k))
    cv.copy_(torch.where(take, v[rows, src_c].to(cv.dtype), cache.v))
    return o.reshape(q.shape).to(q.dtype), KVCache(ck, cv)


def apply(params: dict, cfg, x: torch.Tensor, *, positions: torch.Tensor,
          cache: Optional[KVCache] = None, cache_index=None,
          causal: bool = True, window: Optional[int] = None,
          out: Optional[KVCache] = None
          ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """The attention block body (no residual, no norm).

    * ``cache=None``: the cache-less forward;
    * a cache, ``x`` longer than one token, no ``cache_index``: the
      whole-prompt prefill, writing the cache from position 0 (a ring
      cache takes the prompt's last ``T`` positions, rolled to their
      slots);
    * a cache and a ``cache_index``, longer than one token: the chunked
      prefill (:func:`chunk_attention`);
    * one token: the decode step, writing slot ``index`` (``index % T``
      in a ring) of each row.
    """
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = layers.rope(_split_heads(layers.linear(params["wq"], x), nq, hd),
                    positions, theta=cfg.rope_theta)
    k = layers.rope(_split_heads(layers.linear(params["wk"], x), nkv, hd),
                    positions, theta=cfg.rope_theta)
    v = _split_heads(layers.linear(params["wv"], x), nkv, hd)
    softcap = cfg.attn_logit_softcap
    new_cache = None
    if cache is None:
        o = full_attention(q, k, v, causal=causal, window=window,
                           use_flash=cfg.use_flash, logit_softcap=softcap,
                           probs_bf16=cfg.attn_probs_bf16)
    elif s > 1 and cache_index is not None:
        o, new_cache = chunk_attention(
            q, k, v, cache, cache_index, window=window,
            logit_softcap=softcap, probs_bf16=cfg.attn_probs_bf16, out=out,
            q_pos=positions)
    elif s > 1:
        T = cache.k.shape[1]
        ck, cv = _targets(cache, out)
        if window is not None and T == window and s >= T:
            ck.copy_(torch.roll(k[:, -T:], s % T, dims=1))
            cv.copy_(torch.roll(v[:, -T:], s % T, dims=1))
        else:
            if s > T:
                raise ValueError(f"prefill of {s} tokens into a linear "
                                 f"cache of {T}")
            ck[:, :s] = k
            cv[:, :s] = v
        new_cache = KVCache(ck, cv)
        o = full_attention(q, k, v, causal=causal, window=window,
                           use_flash=cfg.use_flash, logit_softcap=softcap,
                           probs_bf16=cfg.attn_probs_bf16)
    else:
        T = cache.k.shape[1]
        ring = window is not None and T == window
        idx = cache_index.cpu().numpy() if isinstance(
            cache_index, torch.Tensor) else np.asarray(cache_index, np.int64)
        ck, cv = _targets(cache, out)
        if idx.ndim:
            pos = positions.expand(b, 1)                   # idx on the device
            slot = idx % T if ring else idx
            slot_dev = torch.remainder(pos, T) if ring else pos
            _scatter_rows(ck, slot.reshape(-1, 1), slot_dev, k)
            _scatter_rows(cv, slot.reshape(-1, 1), slot_dev, v)
            cache_len = torch.clamp_max(pos[:, 0] + 1, T) if ring else \
                pos[:, 0] + 1
        else:
            # A scalar start is clamped into the cache, as
            # dynamic_update_slice clamps it.
            j = int(min(max(int(idx % T if ring else idx), 0), T - 1))
            ck[:, j] = k[:, 0]
            cv[:, j] = v[:, 0]
            cache_len = int(min(idx + 1, T) if ring else idx + 1)
        new_cache = KVCache(ck, cv)
        o = decode_attention(q, new_cache, cache_len,
                             window=None if ring else window,
                             logit_softcap=softcap)
    y = layers.linear(params["wo"], o.reshape(b, s, nq * hd))
    return y, new_cache


def snapshot_keep_len(T: int, index: Optional[int],
                      window: Optional[int]) -> int:
    """The KV positions a snapshot of a cache of ``T`` slots keeps after
    ``index`` consumed tokens (the JAX package's byte-accounting rule):
    a ring (``T == window``) whole, since which slots hold what depends on
    the position; a linear cache ``[0, index)``, the rest being zeros;
    everything when ``index`` is ``None``."""
    if window is not None and T == window:
        return T
    return T if index is None else max(0, min(int(index), T))
