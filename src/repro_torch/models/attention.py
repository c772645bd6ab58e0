"""Attention: the blockwise (flash-style) prefill path and the decode path,
counterpart of ``repro.models.attention``.

* **Blockwise online softmax** — q is processed in ``chunk_q`` tiles, each
  walking kv in ``chunk_kv`` tiles with a running ``(acc, m, l)`` softmax
  state in float32, so no S x S score matrix is materialised.  The port
  keeps the reference's chunking, its pad-to-chunk with ``kv_len``
  masking, its additive ``NEG_INF`` bias and its operation order, so
  results stay within float32 rounding of the reference; it is written in
  plain torch ops (no library attention).
* **GQA** is computed in grouped form (q reshaped ``(B, S, Hk, G, hd)``),
  kv contracted once per kv head.
* **Folded causal schedule** (``fold=True``): plain blockwise causal
  attention walks all Nq x Nkv block pairs and masks half of them away.
  The fold computes only the lower-triangular blocks, kv blocks
  ``0..iq`` for q chunk ``iq`` in order.  (The reference pairs chunk
  ``p`` with chunk ``Nq-1-p``, ``p+1`` and ``Nq-p`` blocks, so that every
  step of its scan does one block; eager torch needs no pairing, and the
  order within a chunk is the same.)  A fully masked block leaves ``(acc,
  m, l)`` unchanged bitwise (its scores sit at ``NEG_INF``, so ``exp``
  gives exact zeros and the correction is exactly 1), so the fold equals
  the plain schedule bitwise.
* **Decode** is one einsum and a masked softmax over the cache, with per-row
  positions (continuous batching).  :func:`flash_decode_shardmap` splits
  the cache over sequence shards of a mesh (`distributed.mesh.Mesh`) and
  combines their partial softmaxes with a ``pmax`` and two sums
  (flash decoding).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import PartitionSpec as P

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int, kv_len: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) additive float32 bias: 0 where attendable, NEG_INF
    elsewhere."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= kv_pos[None, :] > (q_pos[:, None] - window)
    if kv_len is not None:
        ok &= (kv_pos < kv_len)[None, :]
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG_INF)


def _block_update(q, k, v, bias, acc, m, l, scale):
    """One online-softmax update. q:(B,Cq,Hk,G,hd) k/v:(B,Ckv,Hk,hd)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    s = s + bias                                        # (B,Hk,G,Cq,Ckv)
    m_new = torch.maximum(m, s.amax(dim=-1))            # (B,Hk,G,Cq)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype), v)
    acc_new = acc * corr[..., None] + pv.float()
    return acc_new, m_new, l_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    chunk_q: int = 1024, chunk_kv: int = 1024,
                    kv_len: Optional[int] = None,
                    fold: bool = False) -> torch.Tensor:
    """Blockwise attention. q: (B,Sq,H,hd); k,v: (B,Skv,Hk,hd) ->
    (B,Sq,H,hd) in q's dtype.

    ``fold=True`` takes the folded causal schedule where it applies
    (causal, no window, square, equal chunks, an even number >= 2 of q
    chunks) and the plain one elsewhere, as the reference does."""
    B, Sq, H, hd = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = hd ** -0.5
    Cq, Ckv = min(chunk_q, Sq), min(chunk_kv, Skv)
    if Sq % Cq or Skv % Ckv:
        # pad to chunk multiples; padded kv masked via kv_len, padded q rows
        # are computed on garbage and sliced off below.
        Sq_p = -(-Sq // Cq) * Cq
        Skv_p = -(-Skv // Ckv) * Ckv
        if kv_len is None:
            kv_len = Skv
        qp = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
        kp = F.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
        vp = F.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
        out = flash_attention(qp, kp, vp, causal=causal, window=window,
                              chunk_q=Cq, chunk_kv=Ckv, kv_len=kv_len,
                              fold=fold)
        return out[:, :Sq]
    Nq, Nkv = Sq // Cq, Skv // Ckv
    qg = q.reshape(B, Nq, Cq, Hk, G, hd)
    kc = k.reshape(B, Nkv, Ckv, Hk, hd)
    vc = v.reshape(B, Nkv, Ckv, Hk, hd)
    fold = fold and causal and window == 0 and Sq == Skv and Cq == Ckv \
        and Nq % 2 == 0 and Nq >= 2
    # folded, q chunk iq walks only kv blocks 0..iq
    outs = [_q_chunk(qg, kc, vc, iq, iq + 1 if fold else Nkv, scale, causal,
                     window, kv_len) for iq in range(Nq)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)


def _q_chunk(qg, kc, vc, iq: int, n_kv: int, scale: float, causal: bool,
             window: int, kv_len: Optional[int]) -> torch.Tensor:
    """q-chunk ``iq`` over kv blocks ``0..n_kv-1`` in order: (B,Cq,Hk,G,hd)
    in float32."""
    B, _, Cq, Hk, G, hd = qg.shape
    Ckv = kc.shape[2]
    dev = qg.device
    q_pos = iq * Cq + torch.arange(Cq, device=dev)
    acc = torch.zeros((B, Hk, G, Cq, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Hk, G, Cq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, Cq), dtype=torch.float32, device=dev)
    for jk in range(n_kv):
        kv_pos = jk * Ckv + torch.arange(Ckv, device=dev)
        bias = _mask_bias(q_pos, kv_pos, causal, window, kv_len)
        acc, m, l = _block_update(qg[:, iq], kc[:, jk], vc[:, jk], bias,
                                  acc, m, l, scale)
    o = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,Hk,G,Cq,hd)
    return o.permute(0, 3, 1, 2, 4)                      # (B,Cq,Hk,G,hd)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos,
                     window: int = 0) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, Hk, hd); pos: an int or a (B,) tensor
    of current positions (per-slot positions support continuous batching).
    Cache entries past ``pos`` (or outside the sliding window) are masked;
    the softmax runs in float32.
    """
    B, S, Hk, hd = k_cache.shape
    H = q.shape[2]
    G = H // Hk
    pos_b = torch.as_tensor(pos, device=q.device).broadcast_to((B,))
    qg = q.reshape(B, Hk, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float()
    s = s * hd ** -0.5
    idx = torch.arange(S, device=q.device)
    ok = idx[None, :] <= pos_b[:, None]                      # (B, S)
    if window > 0:
        ok &= idx[None, :] > (pos_b[:, None] - window)
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def flash_decode_shardmap(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos: int, mesh,
                          seq_axes: Sequence[str],
                          batch_axis: Optional[str] = "data",
                          window: int = 0) -> torch.Tensor:
    """Flash decoding over a mesh: the cache's sequence axis is split over
    ``seq_axes`` (a shard's index folds over them in order), each shard
    computes a partial softmax, and the shards combine with a ``pmax`` of
    the row maxima and ``psum`` of the sums and of the weighted values.

    q: (B, 1, H, hd); caches: (B, S, Hk, hd); ``pos``: one position for
    every row (a scalar).  The batch shards over ``batch_axis`` only where
    ``B`` divides by its size.  Returns (B, 1, H, hd) in q's dtype."""
    B, S, Hk, hd = k_cache.shape
    H = q.shape[2]
    G = H // Hk
    seq_axes = tuple(seq_axes)
    n_seq = 1
    for a in seq_axes:
        n_seq *= mesh.shape[a]
    shard_s = S // n_seq
    bspec = batch_axis if (batch_axis and B % mesh.shape[batch_axis] == 0
                           and B >= mesh.shape[batch_axis]) else None
    q_spec = P(bspec, None, None, None)
    kv_spec = P(bspec, seq_axes if len(seq_axes) > 1 else seq_axes[0],
                None, None)
    qs = col.split(q, q_spec, mesh)
    ks = col.split(k_cache, kv_spec, mesh)
    vs = col.split(v_cache, kv_spec, mesh)
    scores, ms = [], []
    for sh, (qb, kb) in enumerate(zip(qs, ks)):
        base = col.axis_index(mesh, seq_axes, sh) * shard_s
        idx = base + torch.arange(shard_s, device=kb.device)
        qg = qb.reshape(qb.shape[0], Hk, G, hd)
        s = torch.einsum("bkgd,bskd->bkgs", qg, kb).float() * hd ** -0.5
        ok = idx <= pos
        if window > 0:
            ok &= idx > (pos - window)
        s = s.masked_fill(~ok, NEG_INF)
        scores.append(s)
        ms.append(s.amax(dim=-1))                        # (b, Hk, G)
    m_g = col.pmax(ms, seq_axes, mesh)
    ps = [torch.exp(s - m[..., None]) for s, m in zip(scores, m_g)]
    l_g = col.psum([p.sum(dim=-1) for p in ps], seq_axes, mesh)
    o_g = col.psum([torch.einsum("bkgs,bskd->bkgd", p.to(vb.dtype),
                                 vb).float() for p, vb in zip(ps, vs)],
                   seq_axes, mesh)
    outs = [(o / torch.clamp(l, min=1e-30)[..., None]).reshape(
        qb.shape[0], 1, H, hd).to(qb.dtype)
        for o, l, qb in zip(o_g, l_g, qs)]
    return col.join(outs, q_spec, mesh)


# ---------------------------------------------------------------------------
# Cache update
# ---------------------------------------------------------------------------

def cache_insert(cache: torch.Tensor, new: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """A copy of ``cache`` with ``new`` written at ``pos`` on the sequence
    axis (the start clamped so that it fits, as ``dynamic_update_slice``
    does). cache: (B,S,Hk,hd); new: (B,n,Hk,hd)."""
    n, S = new.shape[1], cache.shape[1]
    start = min(max(int(pos), 0), S - n)
    out = cache.clone()
    out[:, start:start + n] = new.to(cache.dtype)
    return out
