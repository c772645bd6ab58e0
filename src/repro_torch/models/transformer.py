"""The decoder stack's serving path, counterpart of the serving parts of
``repro.models.transformer``.

Three entry points:

  * :func:`forward`     — full-sequence forward (hidden states, and the
                          per-layer contributions to the decode caches);
  * :func:`prefill`     — runs a prompt, fills the decode caches and
                          returns the last token's logits;
  * :func:`decode_step` — one token for every cache row, each row at its
                          own position (continuous batching).

Layer kinds: global and sliding-window (local) attention with RoPE and
GQA, the RG-LRU block, and the dense gated FFN; with
``cfg.sd_decode_frac > 0`` the RG-LRU layers decode through sigma-delta
event-gated matvecs (``core/sd_decode.py``).  MoE, mLSTM / sLSTM, cross
attention, the encoder, the modality frontends and int8 weights are not
ported (ROADMAP Queue A) and are refused.

Parameters and caches hold one entry per layer (``params["layers"][i]``,
``cache[i]``), where the reference stacks scan groups;
``repro_torch.weights.lm_params_from_numpy`` unstacks the reference's.
A local-attention layer's cache is a ring of ``min(S, window)`` slots,
token ``t`` in slot ``t % window``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.sd_decode import (ffn_step_sd, rglru_step_sd,
                                        sd_state_decls)
from repro_torch.device import resolve_device
from repro_torch.models import config as C
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (DeclTree, ParamDecl, ParamTree,
                                       count_params, ffn_apply, ffn_decls,
                                       init_tree, rms_norm, rope, tree_map)
from repro_torch.models.recurrent import (rglru_block, rglru_block_step,
                                          rglru_decls)

Cache = List[Dict[str, Any]]

_ATTN = (C.ATTN_GLOBAL, C.ATTN_LOCAL)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what the port has not ported, naming the ROADMAP item."""
    item = "ROADMAP Queue A, LM substrate item"
    for spec in cfg.layers:
        if spec.mixer in (C.MLSTM, C.SLSTM):
            raise NotImplementedError(f"{cfg.name}: xLSTM blocks are not "
                                      f"ported ({item} 3)")
        if spec.mixer not in _ATTN + (C.RGLRU,):
            raise NotImplementedError(f"{cfg.name}: mixer {spec.mixer!r} "
                                      f"is not ported ({item} 4)")
        if spec.ffn == C.FFN_MOE:
            raise NotImplementedError(f"{cfg.name}: MoE layers are not "
                                      f"ported ({item} 2)")
        if spec.ffn != C.FFN_DENSE:
            raise NotImplementedError(f"{cfg.name}: ffn {spec.ffn!r} is "
                                      f"not ported ({item} 3)")
        if spec.cross_attn:
            raise NotImplementedError(f"{cfg.name}: cross attention is not "
                                      f"ported ({item} 4)")
    if cfg.encoder is not None or cfg.frontend is not None \
            or cfg.pos_emb != "rope":
        raise NotImplementedError(f"{cfg.name}: the encoder and frontends "
                                  f"are not ported ({item} 4)")
    if cfg.weight_quant != "none":
        raise NotImplementedError(f"{cfg.name}: weight_quant="
                                  f"{cfg.weight_quant!r} is not ported "
                                  f"({item} 1)")


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def _with_dtype(tree: DeclTree, dt: torch.dtype) -> DeclTree:
    return tree_map(lambda d: dataclasses.replace(d, dtype=dt), tree)


def attn_decls(cfg: ModelConfig) -> DeclTree:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDecl((d, H * hd)),
        "wk": ParamDecl((d, Hk * hd)),
        "wv": ParamDecl((d, Hk * hd)),
        "wo": ParamDecl((H * hd, d)),
    }


def layer_decls(cfg: ModelConfig, spec: LayerSpec) -> DeclTree:
    d = cfg.d_model
    out: DeclTree = {"norm": ParamDecl((d,), init="zeros")}
    if spec.mixer in _ATTN:
        out["attn"] = attn_decls(cfg)
    else:
        out["rglru"] = rglru_decls(d, cfg.lru_dim, cfg.conv1d_width)
    out["ffn_norm"] = ParamDecl((d,), init="zeros")
    out["ffn"] = ffn_decls(d, cfg.d_ff)
    # every leaf in the model's dtype, as in the reference
    return _with_dtype(out, cfg.tdtype)


def model_decls(cfg: ModelConfig) -> DeclTree:
    check_supported(cfg)
    out: DeclTree = {
        "embed": ParamDecl((cfg.vocab_padded, cfg.d_model), scale=0.02),
        "final_norm": ParamDecl((cfg.d_model,), init="zeros"),
        "layers": [layer_decls(cfg, s) for s in cfg.layers],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDecl((cfg.d_model, cfg.vocab_padded))
    return _with_dtype(out, cfg.tdtype)


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> ParamTree:
    """Random parameters drawn from ``gen`` (a generator on ``device``;
    default: the CUDA device, raising without one)."""
    return init_tree(gen, model_decls(cfg), resolve_device(device))


def param_count(cfg: ModelConfig) -> int:
    return count_params(model_decls(cfg))


# ---------------------------------------------------------------------------
# Full sequence (prefill)
# ---------------------------------------------------------------------------


def _attention(p: ParamTree, cfg: ModelConfig, mixer: str, x: torch.Tensor,
               positions: torch.Tensor):
    """Full-sequence causal attention. Returns (out, (k, v))."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hk, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hk, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(
        q, k, v, causal=True,
        window=cfg.window if mixer == C.ATTN_LOCAL else 0,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        fold=cfg.causal_fold)
    return o.reshape(B, S, H * hd) @ p["wo"].to(dt), (k, v)


def _layer_forward(p: ParamTree, cfg: ModelConfig, spec: LayerSpec,
                   x: torch.Tensor, positions: torch.Tensor,
                   want_cache: bool = False):
    """One layer, full sequence. Returns (x, cache_contrib)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.mixer in _ATTN:
        o, (k, v) = _attention(p["attn"], cfg, spec.mixer, h, positions)
        if want_cache:
            cache["k"], cache["v"] = k, v
    else:
        o, st = rglru_block(p["rglru"], h, cfg.act)
        if want_cache:
            cache["rglru"] = st
    x = x + o
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h, cfg.act), cache


def forward(params: ParamTree, cfg: ModelConfig, tokens: torch.Tensor,
            want_cache: bool = False) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward of (B, S) int tokens.  Returns the final-normed
    hidden states (B, S, d) and, with ``want_cache``, each layer's cache
    contribution (attention: ``k``/``v``; RG-LRU: its ``h``/``conv``
    state), else empty dicts."""
    check_supported(cfg)
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    caches = []
    for p, spec in zip(params["layers"], cfg.layers):
        x, c = _layer_forward(p, cfg, spec, x, positions, want_cache)
        caches.append(c)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), caches


def unembed(params: ParamTree, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary (``cfg.vocab_padded``); the rows
    past ``cfg.vocab_size`` are the padding of the embedding table."""
    dt = x.dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].to(dt).T
    return x @ params["lm_head"].to(dt)


# ---------------------------------------------------------------------------
# Decode: cache declaration, prefill, single step
# ---------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, spec: LayerSpec, S: int) -> int:
    if spec.mixer == C.ATTN_LOCAL:
        return min(S, cfg.window)
    return S


def cache_decls(cfg: ModelConfig, B: int, S: int) -> List[DeclTree]:
    """Zero-initialised declarations of every layer's decode cache for B
    rows and S positions."""
    check_supported(cfg)
    Hk, hd, dt = cfg.n_kv_heads, cfg.hd, cfg.tdtype
    out = []
    for spec in cfg.layers:
        if spec.mixer in _ATTN:
            kv = ParamDecl((B, _cache_len(cfg, spec, S), Hk, hd),
                           init="zeros", dtype=dt)
            out.append({"k": kv, "v": kv})
            continue
        c = {"rglru": {
            "h": ParamDecl((B, cfg.lru_dim), init="zeros",
                           dtype=torch.float32),
            "conv": ParamDecl((B, cfg.conv1d_width - 1, cfg.lru_dim),
                              init="zeros", dtype=dt)}}
        if cfg.sd_decode_frac > 0:
            c["sd"] = sd_state_decls(B, cfg.d_model, cfg.lru_dim, cfg.d_ff)
        out.append(c)
    return out


def init_cache(cfg: ModelConfig, B: int, S: int, device=None) -> Cache:
    """Zero decode caches on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    return tree_map(lambda d: d.instantiate(None, dev),
                    cache_decls(cfg, B, S))


def _ring_gather(k_seq: torch.Tensor, P: int, W: int) -> torch.Tensor:
    """Lay the last W of P prefill tokens out in ring order (slot = t % W).

    k_seq: (B, P, Hk, hd) -> (B, W, Hk, hd); unwritten slots (P < W) hold
    a copy of token 0, which decode masks (its absolute position is
    negative).
    """
    i = torch.arange(W, device=k_seq.device)
    t = (P - 1) - ((P - 1 - i) % W)
    return k_seq.index_select(1, torch.clamp(t, 0, P - 1))


def _ring_abs_positions(pos: torch.Tensor, W: int) -> torch.Tensor:
    """Absolute token position held by each ring slot after writing ``pos``.

    pos: (B,) per-row positions -> (B, W) absolute positions (negative =
    slot not yet written).
    """
    i = torch.arange(W, device=pos.device)[None, :]
    r = (pos % W)[:, None]
    p = pos[:, None]
    return torch.where(i <= r, p - r + i, p - r - W + i)


def prefill(params: ParamTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None):
    """Run the (B, P) prompt, fill fresh caches of ``cache_len`` positions
    (default P).  Returns (last-token logits (B, 1, V), cache, P - 1).

    With RG-LRU layers, a prompt shorter than ``conv1d_width - 1`` tokens
    (the conv state) raises ``ValueError``: the reference builds a state
    of the wrong shape from it.  Sigma-delta references start at zero, as
    in the reference."""
    B, P = tokens.shape
    need = cfg.conv1d_width - 1 if any(
        s.mixer == C.RGLRU for s in cfg.layers) else 1
    if P < need:
        raise ValueError(f"{cfg.name}: a prompt of {P} tokens is too short; "
                         f"the RG-LRU conv state needs at least {need}")
    S = cache_len or P
    x, raw = forward(params, cfg, tokens, want_cache=True)
    cache = init_cache(cfg, B, S, tokens.device)
    for spec, rc, c in zip(cfg.layers, raw, cache):
        if spec.mixer == C.ATTN_LOCAL:
            L = _cache_len(cfg, spec, S)
            c["k"] = _ring_gather(rc["k"], P, L).to(c["k"].dtype)
            c["v"] = _ring_gather(rc["v"], P, L).to(c["v"].dtype)
        elif spec.mixer == C.ATTN_GLOBAL:
            c["k"][:, :P] = rc["k"]
            c["v"][:, :P] = rc["v"]
        else:
            c["rglru"] = {k: rc["rglru"][k].to(z.dtype)
                          for k, z in c["rglru"].items()}
    return unembed(params, cfg, x[:, -1:, :]), cache, P - 1


def _layer_step(p: ParamTree, cfg: ModelConfig, spec: LayerSpec,
                x_t: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor) -> torch.Tensor:
    """One token through one layer, updating the layer's ``cache`` in
    place. x_t: (B, 1, d); pos: (B,) per-row positions."""
    B = x_t.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x_t.dtype
    h = rms_norm(x_t, p["norm"], cfg.norm_eps)
    sd = cfg.sd_decode_frac > 0
    if spec.mixer in _ATTN:
        a = p["attn"]
        q = (h @ a["wq"].to(dt)).reshape(B, 1, H, hd)
        k = (h @ a["wk"].to(dt)).reshape(B, 1, Hk, hd)
        v = (h @ a["wv"].to(dt)).reshape(B, 1, Hk, hd)
        pp = pos[:, None]                                  # (B, 1)
        q = rope(q, pp, cfg.rope_theta)
        k = rope(k, pp, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        W = kc.shape[1]
        slot = pos % W if spec.mixer == C.ATTN_LOCAL else pos
        rows = torch.arange(B, device=pos.device)
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        if spec.mixer == C.ATTN_LOCAL:
            # ring cache: attend to the slots actually written (abs >= 0)
            written = _ring_abs_positions(pos, W) >= 0       # (B, W)
            qg = q.reshape(B, Hk, H // Hk, hd)
            s = torch.einsum("bkgd,bskd->bkgs", qg, kc).float()
            s = s * hd ** -0.5
            s = s.masked_fill(~written[:, None, None, :], -1e30)
            prob = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgs,bskd->bkgd", prob.to(vc.dtype), vc)
            o = o.reshape(B, 1, H, hd).to(dt)
        else:
            o = decode_attention(q, kc, vc, pos)
        x_t = x_t + o.reshape(B, 1, H * hd) @ a["wo"].to(dt)
    elif sd:
        o, cache["rglru"], cache["sd"] = rglru_step_sd(
            p["rglru"], h, cache["rglru"], cache["sd"], cfg.act,
            cfg.sd_decode_frac)
        x_t = x_t + o
    else:
        o, st = rglru_block_step(p["rglru"], h, cache["rglru"], cfg.act)
        cache["rglru"] = {"h": st["h"], "conv": st["conv"].to(
            cache["rglru"]["conv"].dtype)}
        x_t = x_t + o
    h = rms_norm(x_t, p["ffn_norm"], cfg.norm_eps)
    if sd and spec.mixer == C.RGLRU:
        o, cache["sd"] = ffn_step_sd(p["ffn"], h, cache["sd"], cfg.act,
                                     cfg.sd_decode_frac)
        return x_t + o
    return x_t + ffn_apply(p["ffn"], h, cfg.act)


def decode_step(params: ParamTree, cfg: ModelConfig, cache: Cache,
                token: torch.Tensor, pos):
    """One decode step. token: (B, 1) int; pos: an int or a (B,) int tensor
    holding each row's position of the *new* token.  Updates ``cache`` in
    place.  Returns (logits (B, 1, V), cache, pos + 1)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).long().broadcast_to((B,))
    x_t = params["embed"][token]
    for p, spec, c in zip(params["layers"], cfg.layers, cache):
        x_t = _layer_step(p, cfg, spec, x_t, c, pos)
    x_t = rms_norm(x_t, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x_t), cache, pos + 1
