"""Quantisation for SNE deployment (paper §III-D4: 4-bit weights, 8-bit state).

Counterpart of the deployment half of ``repro.core.quant``:
:func:`quantize_net` lowers a float network to one integer-domain model
(:class:`QuantizedNet`) that serves both dtype policies, with the same
arithmetic as the reference (float32 scales, round-half-to-even, int4
clip), so codes, scales and the integer LIF plan are bitwise equal.  The
QAT fake-quant path (straight-through rounding) belongs to the training
slice and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Sequence, Tuple

import torch

from repro_torch.core.econv import EConvParams
from repro_torch.core.policies import DTYPE_POLICIES, F32_CARRIER, INT8_NATIVE

if TYPE_CHECKING:  # pragma: no cover - annotation only
    from repro_torch.core.sne_net import SNNSpec

INT4_MIN, INT4_MAX = -8, 7
INT8_MIN, INT8_MAX = -128, 127


def weight_scale(w: torch.Tensor, per_channel: bool = True) -> torch.Tensor:
    """Symmetric float32 scale mapping the weight range onto int4.

    ``per_channel=True`` reduces over every axis but the last (keepdims);
    1-D arrays are elementwise.  Dead channels get the ``1e-8`` floor.
    """
    if per_channel:
        axes = tuple(range(w.dim() - 1))
        amax = w.abs().amax(dim=axes, keepdim=True) if axes else w.abs()
    else:
        amax = w.abs().max()
    return torch.clamp(amax, min=1e-8) / INT4_MAX


def quantize_weights_int(w: torch.Tensor, per_channel: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer weight codes (int8 storage of int4 values) + their scale."""
    s = weight_scale(w, per_channel)
    q = torch.clamp(torch.round(w / s), INT4_MIN, INT4_MAX).to(torch.int8)
    return q, s


def requantize_codes(q: torch.Tensor, from_scale, to_scale) -> torch.Tensor:
    """Move integer codes from one grid to another:
    ``clip(round(q · from/to))`` in float32, saturated to int4."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=q.device)
    ratio = f32(from_scale) / f32(to_scale)
    out = torch.round(q.to(torch.float32) * ratio)
    return torch.clamp(out, INT4_MIN, INT4_MAX).to(torch.int8)


def _integer_lif(lif, s_scalar: float, state_bits: int = 8):
    """Express threshold / leak in weight-code units; set the 8-bit clip.

    A lowered threshold above the state clip is rejected: the membrane
    would saturate below threshold and the layer could never fire.
    """
    clip_val = float(2 ** (state_bits - 1) - 1)
    th = float(max(round(lif.threshold / s_scalar), 1))
    if th > clip_val:
        raise ValueError(
            f"integer-domain threshold {th:.0f} exceeds the "
            f"{state_bits}-bit state clip {clip_val:.0f}: the membrane "
            f"saturates below threshold and the layer can never fire "
            f"(threshold {lif.threshold} / weight scale {s_scalar:.4g}) — "
            f"retrain with QAT or rescale before lowering")
    return dataclasses.replace(
        lif,
        threshold=th,
        leak=float(max(round(lif.leak / s_scalar), 0)),
        state_clip=clip_val,
    )


@dataclasses.dataclass(frozen=True)
class QuantizedNet:
    """A whole eCNN lowered to the SNE integer domain, policy-agnostic.

    ``spec`` is the integer-domain spec both dtype policies execute;
    ``codes`` the per-layer int8 execution codes; ``scales`` the
    per-channel side table; ``shared_scales`` the layer-shared execution
    grid; ``packed`` the nibble-packed int4 weight image.
    """

    spec: "SNNSpec"
    codes: Tuple[torch.Tensor, ...]
    scales: Tuple[torch.Tensor, ...]
    shared_scales: Tuple[float, ...]
    packed: Tuple[torch.Tensor, ...]

    def params_for(self, dtype_policy: str) -> List[EConvParams]:
        """Execution weights for one layer-program dtype policy."""
        if dtype_policy == INT8_NATIVE:
            return [EConvParams(w=c) for c in self.codes]
        if dtype_policy == F32_CARRIER:
            return [EConvParams(w=c.to(torch.float32)) for c in self.codes]
        raise ValueError(f"unknown dtype policy {dtype_policy!r} "
                         f"(expected one of {DTYPE_POLICIES})")

    def unpacked_codes(self) -> List[torch.Tensor]:
        """Codes recovered from the packed image (must equal ``codes``)."""
        return [unpack_int4(p, c.numel()).reshape(c.shape)
                for p, c in zip(self.packed, self.codes)]


def quantize_net(params: Sequence[EConvParams], spec: "SNNSpec",
                 per_channel: bool = True,
                 state_bits: int = 8) -> QuantizedNet:
    """Lower a float network to one integer-domain model.

    ``per_channel=True`` keeps per-output-channel scales on the side and
    requantises the executed codes onto the layer-shared grid;
    ``per_channel=False`` quantises straight onto the shared grid.  Pool
    synapses must already be int4-range integers.
    """
    codes, scales, shared, packed, qlayers = [], [], [], [], []
    for i, (p, l) in enumerate(zip(params, spec.layers)):
        w = p.w
        if l.kind == "pool":
            q32 = torch.round(w)
            if (float((w - q32).abs().max()) > 1e-6
                    or float(q32.abs().max()) > INT4_MAX
                    or float(q32.min()) < INT4_MIN):
                raise ValueError(
                    f"layer {i} (pool): synapse weights must be int4-range "
                    f"integers on the integer datapath (got values in "
                    f"[{float(w.min()):.4g}, {float(w.max()):.4g}]) — "
                    f"rescale the pool synapses/threshold before lowering")
            q = q32.to(torch.int8)
            s_side = torch.ones_like(w)
            s_shared = 1.0
        else:
            s_shared = float(weight_scale(w, per_channel=False))
            if per_channel:
                q_pc, s_pc = quantize_weights_int(w, per_channel=True)
                q = requantize_codes(q_pc, s_pc, s_shared)
                s_side = s_pc.reshape(w.shape[-1:])
            else:
                q, _ = quantize_weights_int(w, per_channel=False)
                s_side = torch.full(w.shape[-1:], s_shared,
                                    dtype=torch.float32, device=w.device)
        codes.append(q)
        scales.append(s_side)
        shared.append(s_shared)
        packed.append(pack_int4(q))
        qlayers.append(dataclasses.replace(
            l, lif=_integer_lif(l.lif, s_shared, state_bits)))
    qspec = dataclasses.replace(spec, layers=tuple(qlayers))
    return QuantizedNet(spec=qspec, codes=tuple(codes), scales=tuple(scales),
                        shared_scales=tuple(shared), packed=tuple(packed))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes two per byte (the ASIC weight memory format)."""
    flat = q.to(torch.int32).reshape(-1)
    if flat.shape[0] % 2:
        flat = torch.cat([flat, flat.new_zeros((1,))])
    lo = flat[0::2] & 0xF
    hi = flat[1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: the first ``n`` signed int4 codes."""
    b = packed.to(torch.int32)
    out = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1).reshape(-1)[:n]
    return torch.where(out >= 8, out - 16, out).to(torch.int8)
