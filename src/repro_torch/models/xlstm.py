"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory),
counterpart of ``repro.models.xlstm``.

Both are exponential-gated leaky integrators, the closest relatives of
the paper's LIF dynamics among the assigned architectures: the stabiliser
state ``m`` plays the part of the membrane's saturation logic and the
forget gate is a learned, input-dependent leak.

The full-sequence path is the reference's per-timestep recurrence (its
``xscan_seq``), a Python loop over the sequence
(`models.scan_util.seq_loop`) with every state in float32; the chunkwise-parallel mLSTM form is not in the reference.
Projections are per-head block-diagonal, as in the xLSTM paper.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import DeclTree, ParamDecl, ParamTree
from repro_torch.models.scan_util import seq_loop

State = Tuple[torch.Tensor, ...]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_decls(d_model: int, n_heads: int, proj_factor: int = 2) -> DeclTree:
    di = proj_factor * d_model
    hd = di // n_heads
    return {
        "up": ParamDecl((d_model, 2 * di), ("p_embed", "p_mlp")),
        "wq": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "wk": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "wv": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "wi": ParamDecl((di, n_heads), ("p_mlp", None), scale=di ** -0.5),
        "bi": ParamDecl((n_heads,), (None,), init="zeros"),
        "wf": ParamDecl((di, n_heads), ("p_mlp", None), scale=di ** -0.5),
        "bf": ParamDecl((n_heads,), (None,), init="ones"),
        "down": ParamDecl((di, d_model), ("p_mlp", "p_embed")),
    }


def _mlstm_qkvif(p: ParamTree, xm: torch.Tensor, n_heads: int):
    """xm: (B, S, di) -> per-head q, k, v (B, S, H, hd) and the float32
    log-gates (B, S, H)."""
    B, S, di = xm.shape
    hd = di // n_heads
    dt = xm.dtype
    xh = xm.reshape(B, S, n_heads, hd)
    q = torch.einsum("bshx,hxy->bshy", xh, p["wq"].to(dt))
    k = torch.einsum("bshx,hxy->bshy", xh, p["wk"].to(dt)) * hd ** -0.5
    v = torch.einsum("bshx,hxy->bshy", xh, p["wv"].to(dt))
    li = (xm @ p["wi"].to(dt) + p["bi"].to(dt)).float()
    lf = F.logsigmoid((xm @ p["wf"].to(dt) + p["bf"].to(dt)).float())
    return q, k, v, li, lf


def _mlstm_cell(q_t, k_t, v_t, li_t, lf_t, state: State):
    """One recurrence step, all state float32. q/k/v: (B, H, hd); gates
    (B, H); state (C (B,H,hd,hd), n (B,H,hd), m (B,H))."""
    C, n, m = state
    m_new = torch.maximum(lf_t + m, li_t)
    i_p = torch.exp(li_t - m_new)[..., None]             # (B, H, 1)
    f_p = torch.exp(lf_t + m - m_new)[..., None]
    k32, q32 = k_t.float(), q_t.float()
    kv = torch.einsum("bhx,bhy->bhxy", k32, v_t.float())
    C = f_p[..., None] * C + i_p[..., None] * kv
    n = f_p * n + i_p * k32
    h_num = torch.einsum("bhx,bhxy->bhy", q32, C)
    h_den = torch.einsum("bhx,bhx->bh", q32, n).abs()
    h = h_num / torch.clamp(h_den, min=1.0)[..., None]   # (B, H, hd)
    return (C, n, m_new), h


def _mlstm_out(p: ParamTree, h: torch.Tensor, z: torch.Tensor):
    return (h * F.silu(z)) @ p["down"].to(z.dtype)


def mlstm_block(p: ParamTree, x: torch.Tensor,
                n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """Full sequence (B, S, d): the recurrence stepped over S. Returns the
    block's output and its final state ``{"C", "n", "m"}``."""
    dt = x.dtype
    B, S, _ = x.shape
    xm, z = (x @ p["up"].to(dt)).chunk(2, dim=-1)        # (B, S, di) each
    q, k, v, li, lf = _mlstm_qkvif(p, xm, n_heads)
    di = xm.shape[-1]
    hd = di // n_heads
    f32 = dict(dtype=torch.float32, device=x.device)
    state = (torch.zeros((B, n_heads, hd, hd), **f32),
             torch.zeros((B, n_heads, hd), **f32),
             torch.zeros((B, n_heads), **f32))
    state, h = seq_loop(lambda t, st: _mlstm_cell(
        q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t], st), state, S)
    h = h.reshape(B, S, di).to(dt)
    C, n, m = state
    return _mlstm_out(p, h, z), {"C": C, "n": n, "m": m}


def mlstm_block_step(p: ParamTree, x_t: torch.Tensor, state: Dict,
                     n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x_t: (B, 1, d)."""
    dt = x_t.dtype
    xm, z = (x_t @ p["up"].to(dt)).chunk(2, dim=-1)
    q, k, v, li, lf = _mlstm_qkvif(p, xm, n_heads)
    st, h = _mlstm_cell(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0],
                        (state["C"], state["n"], state["m"]))
    h = h.reshape(x_t.shape[0], 1, xm.shape[-1]).to(dt)
    return _mlstm_out(p, h, z), {"C": st[0], "n": st[1], "m": st[2]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_decls(d_model: int, n_heads: int) -> DeclTree:
    hd = d_model // n_heads
    return {
        "wz": ParamDecl((d_model, d_model), ("p_embed", "p_mlp")),
        "wi": ParamDecl((d_model, d_model), ("p_embed", "p_mlp")),
        "wf": ParamDecl((d_model, d_model), ("p_embed", "p_mlp")),
        "wo": ParamDecl((d_model, d_model), ("p_embed", "p_mlp")),
        "rz": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "ri": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "rf": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "ro": ParamDecl((n_heads, hd, hd), ("p_heads", None, None)),
        "down": ParamDecl((d_model, d_model), ("p_mlp", "p_embed")),
    }


def _slstm_cell(p: ParamTree, zx, ix, fx, ox, state: State):
    """One step. zx..ox: (B, H, hd) float32 pre-activations from x; state
    (c, n, m, h), each (B, H, hd) float32."""
    c, n, m, h = state

    def rec(w):
        return torch.einsum("bhx,hxy->bhy", h, w.float())
    z = torch.tanh(zx + rec(p["rz"]))
    li = ix + rec(p["ri"])
    lf = F.logsigmoid(fx + rec(p["rf"]))
    o = torch.sigmoid(ox + rec(p["ro"]))
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new), h_new


def _slstm_pre(p: ParamTree, x: torch.Tensor, n_heads: int):
    B, S, d = x.shape
    dt = x.dtype

    def pre(w):
        return (x @ w.to(dt)).reshape(B, S, n_heads, d // n_heads).float()
    return pre(p["wz"]), pre(p["wi"]), pre(p["wf"]), pre(p["wo"])


def slstm_block(p: ParamTree, x: torch.Tensor,
                n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """Full sequence (B, S, d), stepped over S. Returns the block's output
    and its final state ``{"c", "n", "m", "h"}``."""
    dt = x.dtype
    B, S, d = x.shape
    zx, ix, fx, ox = _slstm_pre(p, x, n_heads)
    z0 = torch.zeros((B, n_heads, d // n_heads), dtype=torch.float32,
                     device=x.device)
    state = (z0, z0, z0, z0)
    state, h = seq_loop(lambda t, st: _slstm_cell(
        p, zx[:, t], ix[:, t], fx[:, t], ox[:, t], st), state, S)
    h = h.reshape(B, S, d).to(dt)
    c, n, m, hl = state
    return h @ p["down"].to(dt), {"c": c, "n": n, "m": m, "h": hl}


def slstm_block_step(p: ParamTree, x_t: torch.Tensor, state: Dict,
                     n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x_t: (B, 1, d)."""
    dt = x_t.dtype
    B, _, d = x_t.shape
    zx, ix, fx, ox = _slstm_pre(p, x_t, n_heads)
    st, h = _slstm_cell(p, zx[:, 0], ix[:, 0], fx[:, 0], ox[:, 0],
                        (state["c"], state["n"], state["m"], state["h"]))
    h = h.reshape(B, 1, d).to(dt)
    return h @ p["down"].to(dt), {"c": st[0], "n": st[1], "m": st[2],
                                  "h": st[3]}
