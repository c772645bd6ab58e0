"""Sigma-delta event-gated decode: SNE's execution model on LM matvecs,
counterpart of ``repro.core.sd_decode``.

The paper's mechanism — explicit events, a static event capacity, state
updated only where events land — applied to the weight-read-bound decode
of the RG-LRU (recurrentgemma) stack:

  * each linear map keeps a **reference input** ``x_ref`` and its output
    ``y_ref = W^T x_ref``;
  * per step, the ``cap`` largest input deltas are *events*; only their
    weight rows are read and accumulated (``y += dx[idx] @ W[idx]``), so
    weight-read bytes are proportional to the event count;
  * ``cap == d_in`` reproduces the exact network up to float32 rounding;
    smaller ``cap`` trades accuracy for bytes.

State per matvec: ``x_ref (B, d_in) f32`` and ``y_ref (B, d_out) f32``,
one set per RG-LRU layer, riding in the decode cache per slot row.

Under a mesh with a "data" axis that divides ``d_in`` (installed with
``distributed.sharding.set_mesh_rules``), :func:`sd_matvec` and
:func:`sd_matvec_pair` take the reference's row-sharded form: each data
shard selects events among its own rows of ``w`` (SNE's per-cluster event
FIFO), and two sums (``psum``) over "data" combine the partial outputs and the
``x_ref`` updates.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import current_mesh
from repro_torch.models.layers import ParamDecl, activation, gelu
from repro_torch.models.recurrent import rglru_step


def sd_cap(d_in: int, frac: float) -> int:
    """Event budget: ``frac`` of the input width, at least 8."""
    return max(8, min(d_in, int(round(d_in * frac))))


def _events(x: torch.Tensor, x_ref: torch.Tensor, cap: int):
    """Top-cap input deltas: (idx (B,cap), dx (B,cap), new x_ref).

    Where ``|delta|`` ties, ``torch.topk`` may pick other indices than
    ``lax.top_k``; that changes only which of equal deltas are sent (and
    tied zero deltas add nothing), so results agree to rounding."""
    delta = x.float() - x_ref
    idx = torch.topk(delta.abs(), cap, dim=1).indices      # (B, cap)
    dx = torch.gather(delta, 1, idx)                        # (B, cap)
    return idx, dx, x_ref.scatter_add(1, idx, dx)


def _apply_events(w: torch.Tensor, idx: torch.Tensor, dx: torch.Tensor,
                  y_ref: torch.Tensor) -> torch.Tensor:
    """Event-proportional read: y_ref + dx @ W[idx] (cap rows of W), the
    contraction in float32."""
    B, cap = idx.shape
    wg = w.index_select(0, idx.reshape(-1)).reshape(B, cap, -1)
    return y_ref + torch.einsum("bc,bcd->bd", dx, wg.float())


def sd_matvec(w: torch.Tensor, x: torch.Tensor, x_ref: torch.Tensor,
              y_ref: torch.Tensor, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Event-gated ``y = x @ w`` with reference state.

    w: (d_in, d_out); x: (B, d_in); x_ref/y_ref: f32 references.
    Returns (y (B, d_out) in x.dtype, new x_ref, new y_ref)."""
    mesh = _row_mesh(w)
    if mesh is not None:
        return _sd_matvec_sharded(w, x, x_ref, y_ref, cap, mesh)
    idx, dx, x_ref = _events(x, x_ref, cap)
    y = _apply_events(w, idx, dx, y_ref)
    return y.to(x.dtype), x_ref, y


def sd_matvec_pair(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor,
                   x_ref: torch.Tensor, y1_ref: torch.Tensor,
                   y2_ref: torch.Tensor, cap: int):
    """Shared-input event set driving two weight reads (w_in/w_gate,
    ffn gate/up). Returns (y1, y2, x_ref', y1_ref', y2_ref')."""
    mesh = _row_mesh(w1)
    if mesh is not None:
        y1, xr, y1r = _sd_matvec_sharded(w1, x, x_ref, y1_ref, cap, mesh)
        y2, _, y2r = _sd_matvec_sharded(w2, x, x_ref, y2_ref, cap, mesh)
        return y1, y2, xr, y1r, y2r
    idx, dx, xr = _events(x, x_ref, cap)
    y1r = _apply_events(w1, idx, dx, y1_ref)
    y2r = _apply_events(w2, idx, dx, y2_ref)
    return y1r.to(x.dtype), y2r.to(x.dtype), xr, y1r, y2r


def _row_mesh(w: torch.Tensor):
    """The installed mesh where its "data" axis divides ``w``'s rows, else
    None."""
    mesh = current_mesh()
    if mesh is not None and "data" in mesh.shape \
            and w.shape[0] % mesh.shape["data"] == 0:
        return mesh
    return None


def _sd_matvec_sharded(w, x, x_ref, y_ref, cap, mesh):
    """Per-row-shard event selection: data shard ``i`` owns rows ``[i *
    rows, (i + 1) * rows)`` of ``w`` and sends the ``cap_local`` largest
    deltas among them (at least 4, at most its rows); the columns of ``w``
    and ``y_ref`` shard over "model" where it divides ``d_out``."""
    B, d_in = x.shape
    n_data = mesh.shape["data"]
    rows = d_in // n_data
    cap_local = max(4, min(rows, -(-cap // n_data)))
    cols = "model" if w.shape[1] % mesh.shape.get("model", 1) == 0 else None
    ws = col.split(w, P("data", cols), mesh)
    xs = col.split(x, P(None, None), mesh)
    xrs = col.split(x_ref, P(None, None), mesh)
    yrs = col.split(y_ref, P(None, cols), mesh)
    y_parts, upds = [], []
    for sh, (w_l, xb, xr) in enumerate(zip(ws, xs, xrs)):
        i = col.axis_index(mesh, "data", sh)
        delta = xb.float() - xr                             # (B, d_in)
        dloc = delta[:, i * rows:(i + 1) * rows]
        idxl = torch.topk(dloc.abs(), cap_local, dim=1).indices
        dxl = torch.gather(dloc, 1, idxl)
        wg = w_l.index_select(0, idxl.reshape(-1)).reshape(B, cap_local, -1)
        y_parts.append(torch.einsum("bc,bcd->bd", dxl, wg.float()))
        upd = torch.zeros_like(delta)
        upd[:, i * rows:(i + 1) * rows] = torch.zeros(
            (B, rows), dtype=torch.float32, device=delta.device).scatter_add(
            1, idxl, dxl)
        upds.append(upd)
    ys = [yr + yp for yr, yp in zip(yrs, col.psum(y_parts, "data", mesh))]
    xr_new = [xr + u for xr, u in zip(xrs, col.psum(upds, "data", mesh))]
    y = col.join(ys, P(None, cols), mesh)
    return y.to(x.dtype), col.join(xr_new, P(None, None), mesh), y


def sd_state_decls(B: int, d: int, lru: int, d_ff: int) -> Dict[str,
                                                                ParamDecl]:
    """One RG-LRU layer's sigma-delta references (zeros, float32).  The
    hidden-side output references are model-sharded ("act_mlp"), the
    input references replicated (the event selection reads the whole
    delta vector), as in the reference."""
    def ref(dim, shard=False):
        return ParamDecl((B, dim), ("batch", "act_mlp" if shard else None),
                         init="zeros", dtype=torch.float32)

    return {
        "x1_ref": ref(d), "yin_ref": ref(lru, True),
        "ygate_ref": ref(lru, True),
        "x2_ref": ref(lru), "yout_ref": ref(d),
        "xf_ref": ref(d), "yg_ref": ref(d_ff, True),
        "yu_ref": ref(d_ff, True),
        "xd_ref": ref(d_ff), "yd_ref": ref(d),
    }


def rglru_step_sd(p: Dict, x_t: torch.Tensor, cache: Dict, sd: Dict,
                  act, frac: float) -> Tuple[torch.Tensor, Dict, Dict]:
    """Event-gated RG-LRU block decode step (mirror of rglru_block_step)."""
    d = x_t.shape[-1]
    dt = x_t.dtype
    xf = x_t[:, 0, :]                                      # (B, d)
    cap_d = sd_cap(d, frac)
    cap_l = sd_cap(p["w_in"].shape[1], frac)

    # shared-input pair: one event set drives both weight reads
    y1, y2, sd_x1, sd_yin, sd_ygate = sd_matvec_pair(
        p["w_in"], p["w_gate"], xf, sd["x1_ref"], sd["yin_ref"],
        sd["ygate_ref"], cap_d)
    x1 = y1.to(dt)
    gate = gelu(y2.to(dt))
    # causal depthwise conv over the ring of the last W-1 inputs
    w = p["conv_w"].to(dt)
    hist = cache["conv"]                                   # (B, W-1, L)
    window = torch.cat([hist, x1[:, None, :]], dim=1)
    xc = torch.einsum("bwl,wl->bl", window, w) + p["conv_b"].to(dt)
    h_out, h_new = rglru_step(p, xc, cache["h"])
    x2 = h_out * gate                                      # (B, L)
    out, sd_x2, sd_yout = sd_matvec(p["w_out"], x2, sd["x2_ref"],
                                    sd["yout_ref"], cap_l)
    new_cache = {"h": h_new, "conv": window[:, 1:, :].to(hist.dtype)}
    new_sd = dict(sd)
    new_sd.update(x1_ref=sd_x1, yin_ref=sd_yin, ygate_ref=sd_ygate,
                  x2_ref=sd_x2, yout_ref=sd_yout)
    return out[:, None, :], new_cache, new_sd


def ffn_step_sd(p: Dict, x_t: torch.Tensor, sd: Dict, act_name: str,
                frac: float) -> Tuple[torch.Tensor, Dict]:
    """Event-gated SwiGLU decode step."""
    xf = x_t[:, 0, :]
    cap_d = sd_cap(xf.shape[-1], frac)
    cap_f = sd_cap(p["gate"].shape[1], frac)
    g, u, sd_xf, sd_yg, sd_yu = sd_matvec_pair(
        p["gate"], p["up"], xf, sd["xf_ref"], sd["yg_ref"], sd["yu_ref"],
        cap_d)
    g, u = g.to(xf.dtype), u.to(xf.dtype)
    h = activation(act_name)(g) * u                        # (B, f)
    y, sd_xd, sd_yd = sd_matvec(p["down"], h, sd["xd_ref"], sd["yd_ref"],
                                cap_f)
    new_sd = dict(sd)
    new_sd.update(xf_ref=sd_xf, yg_ref=sd_yg, yu_ref=sd_yu,
                  xd_ref=sd_xd, yd_ref=sd_yd)
    return y[:, None, :], new_sd


def read_bytes_per_layer(d: int, lru: int, d_ff: int, frac: float,
                         dtype_bytes: int = 2) -> float:
    """Analytic weight bytes read by one gated rglru layer per token."""
    cap_d = sd_cap(d, frac)
    cap_l = sd_cap(lru, frac)
    cap_f = sd_cap(d_ff, frac)
    return dtype_bytes * (2 * cap_d * lru      # w_in + w_gate rows
                          + cap_l * d          # w_out rows
                          + 2 * cap_d * d_ff   # ffn gate + up rows
                          + cap_f * d)         # ffn down rows
