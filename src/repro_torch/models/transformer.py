"""The decoder (and encoder-decoder) stack, counterpart of
``repro.models.transformer``.

Four entry points:

  * :func:`forward`     — full-sequence forward: hidden states, the MoE
                          stats, and the per-layer contributions to the
                          decode caches;
  * :func:`prefill`     — runs a prompt, fills the decode caches and
                          returns the last token's logits;
  * :func:`decode_step` — one token for every cache row, each row at its
                          own position (continuous batching);
  * :func:`lm_loss`     — the training loss, its CE chunked over the
                          sequence; with ``cfg.remat`` every layer runs
                          under activation checkpointing.

Layer kinds: global, sliding-window (local) and bidirectional attention
with RoPE or sinusoidal positions and GQA, cross attention to an encoder
output, the RG-LRU block, the mLSTM and sLSTM blocks (``models/xlstm.py``),
the dense gated FFN and the MoE FFN (``models/moe.py``), or no FFN.  The
audio stub feeds a bidirectional encoder (``frames=``); the vision stub
overwrites the first prompt positions (``patches=``).  With
``cfg.sd_decode_frac > 0`` the RG-LRU layers decode through sigma-delta
event-gated matvecs (``core/sd_decode.py``).  Int8 weight storage
(``cfg.weight_quant``) is ``models/quant_lm.py``'s: dequantise the tree,
then call these functions, as the reference does.  ``cfg.causal_fold``
takes the folded causal schedule in every full-sequence attention
(``forward``, ``prefill``, ``lm_loss``).  Under a mesh installed with
``distributed.sharding.set_mesh_rules``, ``moe_impl="shardmap"`` runs the
MoE layers through the expert-parallel ``moe_apply_shardmap`` (in
``forward`` and ``decode_step``; without a mesh, the gather path) and the
sigma-delta matvecs take their row-sharded form; gradients flow through
both.

Parameters and caches hold one entry per layer (``params["layers"][i]``,
``cache[i]``; the encoder's ``params["encoder"]["layers"][i]``), where
the reference stacks scan groups; ``repro_torch.weights.
lm_params_from_numpy`` unstacks the reference's.  A local-attention
layer's cache is a ring of ``min(S, window)`` slots, token ``t`` in slot
``t % window``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sd_decode import (ffn_step_sd, rglru_step_sd,
                                        sd_state_decls)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import current_mesh
from repro_torch.models import config as C
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.frontend import apply_frontend, frontend_decls
from repro_torch.models.layers import (DeclTree, ParamDecl, ParamTree,
                                       count_params, ffn_apply, ffn_decls,
                                       init_tree, rms_norm, rope,
                                       sinusoidal_at, sinusoidal_positions,
                                       tree_map)
from repro_torch.models.moe import (MoeStats, moe_apply, moe_apply_shardmap,
                                   moe_decls, zero_stats)
from repro_torch.models.recurrent import (rglru_block, rglru_block_step,
                                          rglru_decls)
from repro_torch.models.xlstm import (mlstm_block, mlstm_block_step,
                                      mlstm_decls, slstm_block,
                                      slstm_block_step, slstm_decls)

Cache = List[Dict[str, Any]]

_ATTN = (C.ATTN_GLOBAL, C.ATTN_LOCAL)
_ENC_SPEC = LayerSpec(C.ATTN_BIDIR, C.FFN_DENSE)


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


def _with_dtype(tree: DeclTree, dt: torch.dtype) -> DeclTree:
    return tree_map(lambda d: dataclasses.replace(d, dtype=dt), tree)


def _norm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), ("p_embed",), init="zeros")


def attn_decls(cfg: ModelConfig) -> DeclTree:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDecl((d, H * hd), ("p_embed", "p_heads")),
        "wk": ParamDecl((d, Hk * hd), ("p_embed", "p_kv_heads")),
        "wv": ParamDecl((d, Hk * hd), ("p_embed", "p_kv_heads")),
        "wo": ParamDecl((H * hd, d), ("p_heads", "p_embed")),
    }


def layer_decls(cfg: ModelConfig, spec: LayerSpec) -> DeclTree:
    d = cfg.d_model
    out: DeclTree = {"norm": _norm_decl(d)}
    if spec.mixer in _ATTN + (C.ATTN_BIDIR,):
        out["attn"] = attn_decls(cfg)
    elif spec.mixer == C.RGLRU:
        out["rglru"] = rglru_decls(d, cfg.lru_dim, cfg.conv1d_width)
    elif spec.mixer == C.MLSTM:
        out["mlstm"] = mlstm_decls(d, cfg.n_heads)
    elif spec.mixer == C.SLSTM:
        out["slstm"] = slstm_decls(d, cfg.n_heads)
    else:
        raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
    if spec.cross_attn:
        out["cross_norm"] = _norm_decl(d)
        out["cross"] = attn_decls(cfg)
    if spec.ffn == C.FFN_DENSE:
        out["ffn_norm"] = _norm_decl(d)
        out["ffn"] = ffn_decls(d, cfg.d_ff)
    elif spec.ffn == C.FFN_MOE:
        out["ffn_norm"] = _norm_decl(d)
        out["moe"] = moe_decls(d, cfg.n_experts, cfg.expert_ff,
                               cfg.shared_expert, cfg.d_ff)
    elif spec.ffn != C.FFN_NONE:
        raise ValueError(f"{cfg.name}: unknown ffn {spec.ffn!r}")
    # every leaf in the model's dtype, as in the reference
    return _with_dtype(out, cfg.tdtype)


def model_decls(cfg: ModelConfig) -> DeclTree:
    out: DeclTree = {
        "embed": ParamDecl((cfg.vocab_padded, cfg.d_model),
                           ("p_vocab", "p_embed"), scale=0.02),
        "final_norm": _norm_decl(cfg.d_model),
        "layers": [layer_decls(cfg, s) for s in cfg.layers],
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDecl((cfg.d_model, cfg.vocab_padded),
                                   ("p_embed", "p_vocab"))
    if cfg.encoder is not None:
        out["encoder"] = {
            "layers": [layer_decls(cfg, _ENC_SPEC)
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": _norm_decl(cfg.d_model),
        }
    fe = frontend_decls(cfg)
    if fe is not None:
        out["frontend"] = fe
    return _with_dtype(out, cfg.tdtype)


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> ParamTree:
    """Random parameters drawn from ``gen`` (a generator on ``device``;
    default: the CUDA device, raising without one)."""
    return init_tree(gen, model_decls(cfg), resolve_device(device))


def decl_axes(decls: DeclTree):
    """The tree of logical-axis tuples, aligned with the parameter tree."""
    return tree_map(lambda d: d.axes, decls)


def param_count(cfg: ModelConfig) -> int:
    return count_params(model_decls(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = param_count(cfg)
    if cfg.n_experts == 0:
        return total
    expert = 3 * cfg.d_model * cfg.expert_ff
    n_moe = sum(1 for l in cfg.layers if l.ffn == C.FFN_MOE)
    return total - n_moe * (cfg.n_experts - cfg.top_k) * expert


# ---------------------------------------------------------------------------
# Full sequence (prefill)
# ---------------------------------------------------------------------------


def _attention(p: ParamTree, cfg: ModelConfig, mixer: str, x: torch.Tensor,
               positions: torch.Tensor,
               kv_src: Optional[torch.Tensor] = None):
    """Full-sequence attention; ``kv_src`` (B, Skv, d) makes it cross
    attention (no positions, not causal). Returns (out, (k, v))."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    src = x if kv_src is None else kv_src
    Skv = src.shape[1]
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (src @ p["wk"].to(dt)).reshape(B, Skv, Hk, hd)
    v = (src @ p["wv"].to(dt)).reshape(B, Skv, Hk, hd)
    if cfg.pos_emb == "rope" and kv_src is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(
        q, k, v, causal=mixer in _ATTN and kv_src is None,
        window=cfg.window if mixer == C.ATTN_LOCAL else 0,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        fold=cfg.causal_fold)
    return o.reshape(B, S, H * hd) @ p["wo"].to(dt), (k, v)


def _moe(p: ParamTree, cfg: ModelConfig, h: torch.Tensor):
    """The MoE dispatch: the expert-parallel form under an installed mesh
    with ``moe_impl="shardmap"``, else the gather form."""
    mesh = current_mesh()
    if cfg.moe_impl == "shardmap" and mesh is not None:
        return moe_apply_shardmap(
            p, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.act,
            shared=cfg.shared_expert, mesh=mesh, seq_shard=cfg.seq_shard)
    return moe_apply(p, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor, act=cfg.act,
                     shared=cfg.shared_expert)


def _mixer_half(p: ParamTree, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, positions: torch.Tensor,
                want_cache: bool = False):
    """The layer's norm, mixer and residual add (the reference's
    ``mixer_out``). Returns (x, cache_contrib)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.mixer in _ATTN + (C.ATTN_BIDIR,):
        o, (k, v) = _attention(p["attn"], cfg, spec.mixer, h, positions)
        if want_cache:
            cache["k"], cache["v"] = k, v
    else:
        if spec.mixer == C.RGLRU:
            o, st = rglru_block(p["rglru"], h, cfg.act)
        elif spec.mixer == C.MLSTM:
            o, st = mlstm_block(p["mlstm"], h, cfg.n_heads)
        else:
            o, st = slstm_block(p["slstm"], h, cfg.n_heads)
        if want_cache:
            cache[spec.mixer] = st      # keyed by the mixer's name
    return x + o, cache


def _ffn_half(p: ParamTree, cfg: ModelConfig, spec: LayerSpec,
              x: torch.Tensor, positions: torch.Tensor,
              enc_out: Optional[torch.Tensor] = None,
              want_cache: bool = False):
    """The rest of the layer: cross attention, then the FFN. Returns (x,
    stats, cache_contrib)."""
    stats = zero_stats(x.device)
    cache: Dict[str, Any] = {}
    if spec.cross_attn:
        hc = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        o, (ck, cv) = _attention(p["cross"], cfg, C.ATTN_BIDIR, hc,
                                 positions, kv_src=enc_out)
        if want_cache:
            cache["cross_k"], cache["cross_v"] = ck, cv
        x = x + o
    if spec.ffn == C.FFN_DENSE:
        h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        x = x + ffn_apply(p["ffn"], h, cfg.act)
    elif spec.ffn == C.FFN_MOE:
        h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        o, stats = _moe(p["moe"], cfg, h)
        x = x + o
    return x, stats, cache


def _layer_forward(p: ParamTree, cfg: ModelConfig, spec: LayerSpec,
                   x: torch.Tensor, positions: torch.Tensor,
                   enc_out: Optional[torch.Tensor] = None,
                   want_cache: bool = False):
    """One layer, full sequence. Returns (x, stats, cache_contrib).

    Under autograd with ``cfg.remat`` (and no cache wanted) the layer runs
    under non-reentrant activation checkpointing: ``"full"`` keeps only
    its input and recomputes the rest in the backward pass;
    ``"boundaries"`` also keeps the mixer half's output (the reference's
    ``save_only_these_names("mixer_out", "layer_out")``).  Remat changes
    what is kept, never a value."""
    if not (cfg.remat and torch.is_grad_enabled()) or want_cache:
        x, cache = _mixer_half(p, cfg, spec, x, positions, want_cache)
        x, stats, c2 = _ffn_half(p, cfg, spec, x, positions, enc_out,
                                 want_cache)
        return x, stats, {**cache, **c2}

    def mixer(x):
        return _mixer_half(p, cfg, spec, x, positions)[0]

    def ffn(x):
        return _ffn_half(p, cfg, spec, x, positions, enc_out)[:2]

    if cfg.remat_policy == "boundaries":
        x = checkpoint(mixer, x, use_reentrant=False)
        x, stats = checkpoint(ffn, x, use_reentrant=False)
    else:
        x, stats = checkpoint(lambda x: ffn(mixer(x)), x,
                              use_reentrant=False)
    return x, stats, {}


def _group_stats(cfg: ModelConfig, layer_stats: List[MoeStats]) -> MoeStats:
    """The reference's reduction of per-layer stats over its scan groups:
    a cycle sums ``aux_loss`` and averages ``dropped_frac`` over its layers
    (the zeros of non-MoE layers included), a group sums and averages over
    its cycles, and the model sums and averages over its groups."""
    groups, i = [], 0
    for specs, count in cfg.scan_groups():
        aux, drop = [], []
        for _ in range(count):
            sts = layer_stats[i:i + len(specs)]
            i += len(specs)
            aux.append(sum(s.aux_loss for s in sts))
            drop.append(sum(s.dropped_frac for s in sts) / len(sts))
        groups.append(MoeStats(aux_loss=torch.stack(aux).sum(),
                               dropped_frac=torch.stack(drop).mean()))
    return MoeStats(
        aux_loss=sum(s.aux_loss for s in groups),
        dropped_frac=sum(s.dropped_frac for s in groups) / len(groups))


def _encoder_forward(params: ParamTree, cfg: ModelConfig,
                     frames: torch.Tensor) -> torch.Tensor:
    """The whisper-style encoder over stub frame features (B, F, d_in)."""
    enc = params["encoder"]
    x = apply_frontend(params["frontend"], cfg, frames)
    Sf = x.shape[1]
    x = x + sinusoidal_positions(Sf, cfg.d_model, x.device).to(x.dtype)[None]
    pos = torch.arange(Sf, device=x.device)
    for p in enc["layers"]:
        x, _, _ = _layer_forward(p, cfg, _ENC_SPEC, x, pos)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def forward(params: ParamTree, cfg: ModelConfig, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            want_cache: bool = False) -> Tuple[torch.Tensor, MoeStats,
                                               Cache]:
    """Full-sequence forward of (B, S) int tokens.  Returns the final-normed
    hidden states (B, S, d), the MoE stats (zeros without MoE layers) and,
    with ``want_cache``, each layer's cache contribution (attention:
    ``k``/``v``; cross attention: ``cross_k``/``cross_v``; the recurrent
    blocks: their final state), else empty dicts.

    ``frames`` (B, F, d_in): the audio stub's features, encoded and
    cross-attended to.  ``patches`` (B, n, d): the vision stub's
    embeddings, which overwrite the first n token positions; a prompt
    shorter than n raises ``ValueError`` (the reference builds a sequence
    of the wrong length from it)."""
    S = tokens.shape[1]
    # F.embedding, not indexing: its backward sums a token's rows in one
    # fixed order on both devices (index_put_'s CPU accumulation does not)
    x = F.embedding(tokens, params["embed"])
    if cfg.frontend == "vision":
        if patches is None:
            raise ValueError(f"{cfg.name}: the vision stub needs patches=")
        npat = patches.shape[1]
        if S < npat:
            raise ValueError(f"{cfg.name}: a prompt of {S} tokens is too "
                             f"short for {npat} patches; it needs at least "
                             f"{npat}")
        pe = apply_frontend(params["frontend"], cfg, patches).to(x.dtype)
        x = torch.cat([pe, x[:, npat:, :]], dim=1)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(
            x.dtype)[None]
    enc_out = None
    if cfg.encoder is not None:
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder needs frames=")
        enc_out = _encoder_forward(params, cfg, frames)
    positions = torch.arange(S, device=tokens.device)
    caches, stats = [], []
    for p, spec in zip(params["layers"], cfg.layers):
        x, st, c = _layer_forward(p, cfg, spec, x, positions, enc_out,
                                  want_cache)
        stats.append(st)
        caches.append(c)
    return (rms_norm(x, params["final_norm"], cfg.norm_eps),
            _group_stats(cfg, stats), caches)


def unembed(params: ParamTree, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocabulary (``cfg.vocab_padded``); the rows
    past ``cfg.vocab_size`` are the padding of the embedding table."""
    dt = x.dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].to(dt).T
    return x @ params["lm_head"].to(dt)


# ---------------------------------------------------------------------------
# Loss (chunked over the sequence so the (B, S, V) logits never exist)
# ---------------------------------------------------------------------------


def _chunk_nll(params: ParamTree, cfg: ModelConfig, xb: torch.Tensor,
               lb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's summed NLL over the labels >= 0, and their count.

    xb: (B, C, d) hidden states; lb: (B, C) labels, < 0 ignored.  The
    logits run in float32 with the padded vocabulary tail at -1e30.
    ``cfg.vp_loss`` takes the reference's vocab-parallel form,
    ``logsumexp - target`` (it rounds otherwise than ``log_softmax`` and a
    gather)."""
    vocab = cfg.vocab_size
    logits = unembed(params, cfg, xb).float()
    iota = torch.arange(cfg.vocab_padded, device=xb.device)
    if cfg.vp_loss:
        logits = torch.where(iota < vocab, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.sum(torch.where(iota == lb[..., None], logits, 0.0),
                        dim=-1)
        nll = lse - tgt
    else:
        if cfg.vocab_padded > vocab:
            logits = torch.where(iota < vocab, logits, -1e30)
        logp = torch.log_softmax(logits, dim=-1)
        # jnp.take_along_axis wraps a negative label, torch.gather raises
        # on one: clamp it, the ``ok`` mask zeroes its term either way
        nll = -torch.gather(logp, -1, lb.clamp(min=0)[..., None])[..., 0]
    ok = (lb >= 0).float()
    return torch.sum(nll * ok), torch.sum(ok)


def lm_loss(params: ParamTree, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            loss_chunk: int = 512) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """Causal-LM loss: the mean NLL of the labels >= 0, plus
    ``router_aux_coef · aux_loss`` with MoE layers.  Returns (loss,
    {"ce", "aux_loss", "moe_dropped", "tokens"}).

    The CE runs over ``S // loss_chunk`` sequence chunks in order, each
    under non-reentrant checkpointing (the reference's ``jax.checkpoint``
    in a scan), so the (B, C, V) float32 logits exist for one chunk at a
    time and are recomputed in the backward pass."""
    x, stats, _ = forward(params, cfg, tokens, frames, patches)
    S = x.shape[1]
    CS = min(loss_chunk, S)
    assert S % CS == 0, f"sequence {S} is not a multiple of chunk {CS}"
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    denom = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, CS):
        args = (params, cfg, x[:, i:i + CS], labels[:, i:i + CS])
        nll, n = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                  if torch.is_grad_enabled() else _chunk_nll(*args))
        total, denom = total + nll, denom + n
    ce = total / torch.clamp(denom, min=1.0)
    loss = ce + cfg.router_aux_coef * stats.aux_loss if cfg.n_experts else ce
    return loss, {"ce": ce, "aux_loss": stats.aux_loss,
                  "moe_dropped": stats.dropped_frac, "tokens": denom}


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
    H, Hk, hd, dt = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.tdtype
    f32 = torch.float32
    out = []
    for spec in cfg.layers:
        c: DeclTree = {}
        if spec.mixer in _ATTN + (C.ATTN_BIDIR,):
            seq_ax = "kv_window" if spec.mixer == C.ATTN_LOCAL else "kv_seq"
            kv = ParamDecl((B, _cache_len(cfg, spec, S), Hk, hd),
                           ("batch", seq_ax, "p_kv_heads", None),
                           init="zeros", dtype=dt)
            c["k"], c["v"] = kv, kv
        elif spec.mixer == C.RGLRU:
            c["rglru"] = {
                "h": ParamDecl((B, cfg.lru_dim), ("batch", "act_mlp"),
                               init="zeros", dtype=f32),
                "conv": ParamDecl((B, cfg.conv1d_width - 1, cfg.lru_dim),
                                  ("batch", None, "act_mlp"), init="zeros",
                                  dtype=dt)}
            if cfg.sd_decode_frac > 0:
                c["sd"] = sd_state_decls(B, cfg.d_model, cfg.lru_dim,
                                         cfg.d_ff)
        elif spec.mixer == C.MLSTM:
            hdm = 2 * cfg.d_model // H
            c["mlstm"] = {
                "C": ParamDecl((B, H, hdm, hdm),
                               ("batch", None, None, "act_mlp"),
                               init="zeros", dtype=f32),
                "n": ParamDecl((B, H, hdm), ("batch", None, "act_mlp"),
                               init="zeros", dtype=f32),
                "m": ParamDecl((B, H), ("batch", None), init="zeros",
                               dtype=f32)}
        elif spec.mixer == C.SLSTM:
            # small state feeding per-step recurrent matvecs: batch-sharded
            # only, as in the reference
            st = ParamDecl((B, H, cfg.d_model // H), ("batch", None, None),
                           init="zeros", dtype=f32)
            c["slstm"] = {"c": st, "n": st, "m": st, "h": st}
        if spec.cross_attn:
            kv = ParamDecl((B, cfg.encoder.n_frames, Hk, hd),
                           ("batch", "kv_seq", "p_kv_heads", None),
                           init="zeros", dtype=dt)
            c["cross_k"], c["cross_v"] = kv, kv
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
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None):
    """Run the (B, P) prompt (with the stub inputs ``frames`` / ``patches``
    where the config has them), fill fresh caches of ``cache_len``
    positions (default P).  Returns (last-token logits (B, 1, V), cache,
    P - 1).

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
    x, _, raw = forward(params, cfg, tokens, frames, patches,
                        want_cache=True)
    cache = init_cache(cfg, B, S, tokens.device)
    for spec, rc, c in zip(cfg.layers, raw, cache):
        if spec.mixer == C.ATTN_LOCAL:
            L = _cache_len(cfg, spec, S)
            c["k"] = _ring_gather(rc["k"], P, L).to(c["k"].dtype)
            c["v"] = _ring_gather(rc["v"], P, L).to(c["v"].dtype)
        elif "k" in rc:
            c["k"][:, :P] = rc["k"]
            c["v"][:, :P] = rc["v"]
        for key in ("rglru", "mlstm", "slstm"):
            if key in rc:
                c[key] = {k: rc[key][k].to(z.dtype)
                          for k, z in c[key].items()}
        if "cross_k" in rc:
            c["cross_k"], c["cross_v"] = rc["cross_k"], rc["cross_v"]
    return unembed(params, cfg, x[:, -1:, :]), cache, P - 1


def _self_attention_step(a: ParamTree, cfg: ModelConfig, mixer: str,
                         h: torch.Tensor, cache: Dict[str, Any],
                         pos: torch.Tensor) -> torch.Tensor:
    """One token of self attention, writing its k/v into the layer's
    cache in place. h: (B, 1, d); pos: (B,)."""
    B = h.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = h.dtype
    q = (h @ a["wq"].to(dt)).reshape(B, 1, H, hd)
    k = (h @ a["wk"].to(dt)).reshape(B, 1, Hk, hd)
    v = (h @ a["wv"].to(dt)).reshape(B, 1, Hk, hd)
    if cfg.pos_emb == "rope":
        pp = pos[:, None]                                  # (B, 1)
        q = rope(q, pp, cfg.rope_theta)
        k = rope(k, pp, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    W = kc.shape[1]
    slot = pos % W if mixer == C.ATTN_LOCAL else pos
    rows = torch.arange(B, device=pos.device)
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    if mixer == C.ATTN_LOCAL:
        # ring cache: attend to the slots actually written (abs >= 0)
        written = _ring_abs_positions(pos, W) >= 0           # (B, W)
        qg = q.reshape(B, Hk, H // Hk, hd)
        s = torch.einsum("bkgd,bskd->bkgs", qg, kc).float()
        s = s * hd ** -0.5
        s = s.masked_fill(~written[:, None, None, :], -1e30)
        prob = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", prob.to(vc.dtype), vc)
        o = o.reshape(B, 1, H, hd).to(dt)
    else:
        o = decode_attention(q, kc, vc, pos)
    return o.reshape(B, 1, H * hd) @ a["wo"].to(dt)


def _layer_step(p: ParamTree, cfg: ModelConfig, spec: LayerSpec,
                x_t: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor) -> torch.Tensor:
    """One token through one layer, updating the layer's ``cache`` in
    place. x_t: (B, 1, d); pos: (B,) per-row positions."""
    B = x_t.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    dt = x_t.dtype
    h = rms_norm(x_t, p["norm"], cfg.norm_eps)
    sd = cfg.sd_decode_frac > 0
    if spec.mixer in _ATTN:
        x_t = x_t + _self_attention_step(p["attn"], cfg, spec.mixer, h,
                                         cache, pos)
    elif spec.mixer == C.RGLRU and sd:
        o, cache["rglru"], cache["sd"] = rglru_step_sd(
            p["rglru"], h, cache["rglru"], cache["sd"], cfg.act,
            cfg.sd_decode_frac)
        x_t = x_t + o
    elif spec.mixer == C.RGLRU:
        o, st = rglru_block_step(p["rglru"], h, cache["rglru"], cfg.act)
        cache["rglru"] = {"h": st["h"], "conv": st["conv"].to(
            cache["rglru"]["conv"].dtype)}
        x_t = x_t + o
    elif spec.mixer == C.MLSTM:
        o, cache["mlstm"] = mlstm_block_step(p["mlstm"], h, cache["mlstm"],
                                             cfg.n_heads)
        x_t = x_t + o
    elif spec.mixer == C.SLSTM:
        o, cache["slstm"] = slstm_block_step(p["slstm"], h, cache["slstm"],
                                             cfg.n_heads)
        x_t = x_t + o
    else:
        raise ValueError(f"{cfg.name}: {spec.mixer!r} layers do not decode")
    if spec.cross_attn:
        hc = rms_norm(x_t, p["cross_norm"], cfg.norm_eps)
        q = (hc @ p["cross"]["wq"].to(dt)).reshape(B, 1, H, hd)
        kc, vc = cache["cross_k"], cache["cross_v"]
        o = decode_attention(q, kc, vc, kc.shape[1] - 1)
        x_t = x_t + o.reshape(B, 1, H * hd) @ p["cross"]["wo"].to(dt)
    if spec.ffn == C.FFN_DENSE:
        h = rms_norm(x_t, p["ffn_norm"], cfg.norm_eps)
        if sd and spec.mixer == C.RGLRU:
            o, cache["sd"] = ffn_step_sd(p["ffn"], h, cache["sd"], cfg.act,
                                         cfg.sd_decode_frac)
            return x_t + o
        return x_t + ffn_apply(p["ffn"], h, cfg.act)
    if spec.ffn == C.FFN_MOE:
        h = rms_norm(x_t, p["ffn_norm"], cfg.norm_eps)
        return x_t + _moe(p["moe"], cfg, h)[0]
    return x_t


def decode_step(params: ParamTree, cfg: ModelConfig, cache: Cache,
                token: torch.Tensor, pos):
    """One decode step. token: (B, 1) int; pos: an int or a (B,) int tensor
    holding each row's position of the *new* token.  Updates ``cache`` in
    place.  Returns (logits (B, 1, V), cache, pos + 1)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).long().broadcast_to((B,))
    x_t = params["embed"][token]
    if cfg.pos_emb == "sinusoidal":
        x_t = x_t + sinusoidal_at(pos, cfg.d_model).to(x_t.dtype)[:, None, :]
    for p, spec, c in zip(params["layers"], cfg.layers, cache):
        x_t = _layer_step(p, cfg, spec, x_t, c, pos)
    x_t = rms_norm(x_t, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x_t), cache, pos + 1
