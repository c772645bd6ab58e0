"""Wrapper of the fused-network window megakernel.

CPU tensors go to the plain PyTorch version (`ref.py`); CUDA tensors
launch ``csrc/network_window.cu`` on the current stream, or raise.

The kernel spreads one slot's network over a thread-block cluster of
:data:`CLUSTER` CTAs, each holding its share of every layer in its shared
memory for the whole window, so what one CTA keeps there is priced here,
once, by :func:`smem_layout`: the executor's fallback rule
(`core.layer_program.network_window_plan`) and the launch read the same
numbers.  The budget is the card's, per CTA: :data:`SMEM_BUDGET`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lif import supports_idle_skip
from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_cuda, lif_args,
                                         on_cpu, raise_on_error,
                                         window_pairing, window_schedule)
from repro_torch.kernels.network_window.ref import network_window_ref
from repro_torch.kernels.network_window.spec import NetLayer
from repro_torch.kernels.window_common import tile_grid

NAME = "network_window"
# The H100's opt-in shared memory per block (227 KiB): the most one CTA of
# the megakernel may hold.  The launcher checks that the card offers it.
SMEM_BUDGET = 232_448
MAX_LAYERS = 12          # the kernel's kMaxLayers
CLUSTER = 8              # CTAs per slot, one thread-block cluster (kCluster)
THREADS = 512            # threads per CTA (kThreads)
PER_LANE = 2             # events a thread filters per stage (kPerLane)
FC_BUF = 4096            # fc weights staged per chunk of events (kFcBuf)
MAX_TILES = 16           # bitmap entries per layer (sne::kMaxTiles)
ALIGN = 16
_KINDS = {"conv": 0, "pool": 1, "fc": 2}


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class SmemLayout(NamedTuple):
    """Byte offsets of one CTA's shared memory, and their sizes."""
    mem_off: Tuple[int, ...]       # per layer: the share's accumulators
    mask_off: Tuple[int, ...]      # per layer: its site masks
    w_off: Tuple[int, ...]         # per layer: staged weights (-1 for fc)
    hot_off: int                   # MAX_TILES ints per layer: the bitmaps
    bits_off: int                  # one bit per frame site of the share
    list_off: int                  # segment counts, then two routed lists
    kept_off: int                  # the kept events of a stage (16 bytes)
    tally_off: int                 # scan scratch, list starts, counts
    fcbuf_off: int                 # fc weight rows of a chunk of events
    list_cap: int                  # entries of one routed list
    seg_cap: int                   # frame segments a CTA owns, at most
    nseg_cap: int                  # segments of a frame, at most
    membrane_bytes: int
    weight_bytes: int
    tile_bytes: int
    frame_bytes: int
    stage_bytes: int

    @property
    def total(self) -> int:
        """Dynamic shared memory of one CTA (bytes)."""
        return (self.membrane_bytes + self.weight_bytes + self.tile_bytes
                + self.frame_bytes + self.stage_bytes)


def share_shape(nl: NetLayer, slab: Sequence[int]) -> Tuple[int, int, int]:
    """The widest CTA share of one layer, as the kernel's ``share_of`` cuts
    them: ``(owned positions, site-mask words, frame sites)``.  Conv and
    pool layers go to the cluster's CTAs a row at a time, row r to CTA
    r mod CLUSTER: at most ``ceil(Hp / CLUSTER)`` slab rows (halo rows
    counted) of all Wp columns for a conv, one hot bit a site in words of
    a row, of which ``ceil(Ho / CLUSTER)`` interior rows of the frame; at
    most ``ceil(Ho / CLUSTER)`` output rows for a pool.  An fc share is
    ``ceil(C / CLUSTER)`` columns, one hot bit a site."""
    Hp, Wp, C = slab
    Ho, Wo = Hp - 2 * nl.halo, Wp - 2 * nl.halo
    if nl.kind == "fc":
        per = _cdiv(C, CLUSTER)
        return per, _cdiv(per, 32), per
    frame = _cdiv(Ho, CLUSTER) * Wo * C
    if nl.kind == "conv":
        rows = _cdiv(Hp, CLUSTER)
        return rows * Wp * C, rows * _cdiv(Wp, 32), frame
    return frame, _cdiv(frame, 32), frame


@functools.lru_cache(maxsize=64)
def smem_layout(layers: Tuple[NetLayer, ...],
                slabs: Tuple[Tuple[int, int, int], ...],
                w_itemsize: int) -> SmemLayout:
    """Lay out one CTA's shared memory, for its widest share of every layer.

    Args:
      layers:     the per-layer plans (:class:`NetLayer`).
      slabs:      per layer, the halo-padded slab's (Hp, Wp, C); every
                  site is held in a 4-byte accumulator.
      w_itemsize: bytes per weight (4 on the carrier, 1 native).  Conv
                  (K x K x Ci x C) and pool (C) weights are staged in
                  every CTA; the fc matrices stay in device memory.
    """
    L = len(layers)
    shares = [share_shape(nl, slab) for nl, slab in zip(layers, slabs)]
    off = 0
    mem_off, mask_off, w_off = [], [], []
    for mem, _, _ in shares:
        mem_off.append(off)
        off += _align(4 * mem)
    for _, words, _ in shares:
        mask_off.append(off)
        off += _align(4 * words)
    membrane = off
    for nl, (_, _, C) in zip(layers, slabs):
        K, Ci = nl.halo + 1, nl.in_shape[2]
        e = {"conv": K * K * Ci * C, "pool": C, "fc": 0}[nl.kind]
        w_off.append(off if e else -1)
        off += _align(w_itemsize * e)
    weight = off - membrane
    hot_off = off
    tile = _align(4 * MAX_TILES * L)
    bits_off = hot_off + tile
    frames = [f for _, _, f in shares]
    list_cap = max([min(f, nxt.cap) for f, nxt in zip(frames, layers[1:])],
                   default=1)
    # a frame's segments: its rows (conv, pool) or the CTAs' column shares
    rows = [sl[0] - 2 * nl.halo for nl, sl in zip(layers, slabs)]
    seg_cap = max(1 if nl.kind == "fc" else _cdiv(r, CLUSTER)
                  for nl, r in zip(layers, rows))
    nseg_cap = max(CLUSTER, *(r for nl, r in zip(layers, rows)
                              if nl.kind != "fc"))
    list_off = bits_off + _align(4 * _cdiv(max(frames), 32))
    kept_off = list_off + _align(4 * (-(-2 * seg_cap // 4) * 4
                                      + 2 * list_cap))
    tally_off = kept_off + 16 * PER_LANE * THREADS
    # scan scratch, the segment table (counts, starts, list starts and
    # end), then the counts and drops
    fcbuf_off = tally_off + _align(4 * (32 + 3 * nseg_cap + 1 + 2 * L))
    end = fcbuf_off + (4 * FC_BUF if any(nl.kind == "fc" for nl in layers)
                       else 0)
    return SmemLayout(tuple(mem_off), tuple(mask_off), tuple(w_off), hot_off,
                      bits_off, list_off, kept_off, tally_off, fcbuf_off,
                      list_cap, seg_cap, nseg_cap, membrane, weight, tile,
                      kept_off - bits_off, end - kept_off)


def _check_layers(layers, states, weights) -> None:
    """Every slab, weight and input geometry agrees with its plan, and
    every slab has the same slots."""
    L = len(layers)
    if not 1 <= L <= MAX_LAYERS or len(states) != L or len(weights) != L:
        raise ValueError(f"{NAME}: {L} layers, {len(states)} slabs, "
                         f"{len(weights)} weights (1..{MAX_LAYERS} layers)")
    prev = None
    for l, (nl, v, w) in enumerate(zip(layers, states, weights)):
        if nl.kind not in _KINDS:
            raise ValueError(f"{NAME}: layer {l}: unknown kind {nl.kind!r}")
        Ho, Wo = v.shape[1] - 2 * nl.halo, v.shape[2] - 2 * nl.halo
        ok = {"conv": w.dim() == 4 and w.shape[0] == w.shape[1]
              and nl.halo == w.shape[0] - 1 and w.shape[3] == v.shape[3]
              and w.shape[2] == nl.in_shape[2],
              "pool": nl.halo == 0 and w.dim() == 1
              and w.shape[0] == v.shape[3] == nl.in_shape[2],
              "fc": nl.halo == 0 and Ho == Wo == 1 and w.dim() == 2
              and w.shape[1] == v.shape[3]
              and w.shape[0] == int(np.prod(nl.in_shape))}[nl.kind]
        if not ok or Ho < 1 or Wo < 1 or v.shape[0] != states[0].shape[0]:
            raise ValueError(f"{NAME}: layer {l} ({nl.kind}): slab "
                             f"{tuple(v.shape)}, weights {tuple(w.shape)} "
                             f"and plan {nl} disagree")
        if prev is not None and tuple(nl.in_shape) != prev:
            raise ValueError(f"{NAME}: layer {l} takes {nl.in_shape}, layer "
                             f"{l - 1} emits {prev}")
        prev = (Ho, Wo, v.shape[3])


def network_window(states: Sequence[torch.Tensor],
                   weights: Sequence[torch.Tensor], ev_xyc: torch.Tensor,
                   ev_gate: torch.Tensor, alive: torch.Tensor, *,
                   layers: Tuple[NetLayer, ...], native: bool = False,
                   tiles: Optional[Sequence[torch.Tensor]] = None):
    """Advance N slots through a whole window, all layers, in ONE launch.

    Arguments and result as :func:`ref.network_window_ref`.  A zero-length
    layer-0 event axis still runs the window (one gated-off event).
    ``tiles`` needs every layer hard-reset; None runs every tile.  On the
    card one cluster of :data:`CLUSTER` CTAs of :data:`THREADS` threads
    serves one slot: each CTA keeps its share of every slab, the conv and
    pool weights, the bitmaps and its routed lists in its shared memory for
    the whole window, which must fit :data:`SMEM_BUDGET` (the launcher
    refuses more; the executor falls back to the fused-window lowering
    before it asks for more).
    """
    _check_layers(layers, states, weights)
    if tiles is not None and not all(supports_idle_skip(nl.lif)
                                     for nl in layers):
        raise ValueError(
            f"{NAME}: tile sparsity requires hard-reset layers "
            f"(reset_mode='zero'): cold-tile decay has no closed form under "
            f"soft reset")
    L = len(layers)
    acc, ev_xyc, ev_gate, alive = window_schedule(NAME, states[0], ev_xyc,
                                                  ev_gate, alive, native)
    N, T, E0 = ev_xyc.shape[:3]
    grids = [tile_grid(v.shape[1] - 2 * nl.halo, v.shape[2] - 2 * nl.halo)
             for nl, v in zip(layers, states)]
    codes = {window_pairing(NAME, v, w, ev_gate, acc)
             for v, w in zip(states, weights)}
    if len(codes) != 1:
        raise TypeError(f"{NAME}: the layers mix dtype pairings")
    if tiles is not None:
        if len(tiles) != L:
            raise ValueError(f"{NAME}: {len(tiles)} bitmaps for {L} layers")
        for l, (tl, g) in enumerate(zip(tiles, grids)):
            if tuple(tl.shape) != (N, g[0], g[1]):
                raise ValueError(f"{NAME}: layer {l} tiles shape "
                                 f"{tuple(tl.shape)} != {(N, g[0], g[1])}")
    if on_cpu(*states, *weights, ev_xyc, ev_gate, alive, *(tiles or ())):
        return network_window_ref(states, weights, ev_xyc, ev_gate, alive,
                                  layers=layers, native=native, tiles=tiles)
    if tiles is not None:
        tiles = [tl.to(torch.int32).contiguous() for tl in tiles]
    dev = check_cuda(NAME, *states, *weights, ev_xyc, ev_gate, alive,
                     *(tiles or ()))
    lay = smem_layout(tuple(layers),
                      tuple(tuple(v.shape[1:]) for v in states),
                      weights[0].element_size())
    desc = np.zeros((L, 23), np.int32)
    lif = np.zeros((L, 3), np.float32)
    ptrs = np.zeros((L, 4), np.uint64)
    v_out = [torch.empty_like(v) for v in states]
    for l, (nl, v, w, g) in enumerate(zip(layers, states, weights, grids)):
        K, Ci = (w.shape[0], w.shape[2]) if nl.kind == "conv" else (1, 1)
        cap = nl.cap if l > 0 else E0
        th, leak, clip, leak_mode, reset_mode, has_clip = lif_args(nl.lif)
        desc[l] = (_KINDS[nl.kind], v.shape[1], v.shape[2], v.shape[3],
                   nl.halo, K, Ci, nl.padding, nl.stride, *nl.in_shape[1:],
                   cap, *g, lay.mem_off[l], lay.mask_off[l], lay.w_off[l],
                   w.shape[0] if nl.kind == "fc" else 0, leak_mode,
                   reset_mode, has_clip)
        lif[l] = (th, leak, clip)
        ptrs[l] = (v.data_ptr(), w.data_ptr(), v_out[l].data_ptr(),
                   0 if tiles is None else tiles[l].data_ptr())
    Hl = states[-1].shape[1] - 2 * layers[-1].halo
    Wl = states[-1].shape[2] - 2 * layers[-1].halo
    s_last = torch.empty((N, T, Hl, Wl, states[-1].shape[3]), dtype=acc,
                         device=dev)
    counts = torch.empty((N, L), dtype=torch.int32, device=dev)
    drops = torch.empty((N, L), dtype=torch.int32, device=dev)
    fn = _build.library(NAME).sne_network_window
    with torch.cuda.device(dev):
        err = fn(desc.ctypes.data, lif.ctypes.data, ptrs.ctypes.data, L,
                 ev_xyc.data_ptr(), ev_gate.data_ptr(), alive.data_ptr(),
                 s_last.data_ptr(), counts.data_ptr(), drops.data_ptr(), N,
                 T, E0, lay.list_cap, lay.seg_cap, lay.nseg_cap,
                 lay.hot_off, lay.bits_off,
                 lay.list_off, lay.kept_off, lay.tally_off, lay.fcbuf_off,
                 lay.total,
                 SMEM_BUDGET, codes.pop(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err < 0:
        raise RuntimeError(
            f"{NAME}: the card offers {-err} bytes of shared memory per "
            f"CTA (cudaDevAttrMaxSharedMemoryPerBlockOptin), less than "
            f"SMEM_BUDGET = {SMEM_BUDGET}, which the fused-network plan "
            f"was priced against")
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return tuple(v_out), s_last, counts, drops
