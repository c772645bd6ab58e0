"""Model configuration for the LM-family architectures (a pure-Python copy
of ``repro.models.config``).

One :class:`ModelConfig` describes any of the ten assigned architectures;
every field of the reference's is kept, so a reference config maps over
one to one.  The port runs every layer kind and every execution knob:
``moe_impl="shardmap"`` and ``seq_shard`` under an installed mesh
(`distributed.sharding.set_mesh_rules`), ``causal_fold`` with or without
one.

The reference groups layers into scan runs (``runs``, ``scan_groups``);
the port keeps both because its weight converter unstacks the reference's
scan-stacked parameters by them, while its own model holds one entry per
layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Mixer kinds.
ATTN_GLOBAL = "attn_global"     # causal full attention
ATTN_LOCAL = "attn_local"       # causal sliding-window attention
ATTN_BIDIR = "attn_bidir"       # encoder (non-causal) attention
RGLRU = "rglru"                 # RecurrentGemma RG-LRU block
MLSTM = "mlstm"                 # xLSTM matrix-memory block
SLSTM = "slstm"                 # xLSTM scalar-memory block

# FFN kinds.
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"               # xLSTM blocks carry their own projections


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config field names (``dtype``, ``grad_dtype``,
    ``moment_dtype``)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str
    ffn: str
    cross_attn: bool = False    # decoder layer attending to encoder output


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_frames: int               # stub-frontend sequence length
    d_input: int                # stub-frontend feature dim (pre-projection)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int             # raw (paper) vocab
    layers: Tuple[LayerSpec, ...]
    head_dim: int = 0           # 0 -> d_model // n_heads
    vocab_pad_to: int = 128     # embedding padded for TP divisibility
    window: int = 0             # sliding window for ATTN_LOCAL
    pos_emb: str = "rope"       # "rope" | "sinusoidal" (whisper)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gather"    # "gather" (baseline) | "shardmap" (EP a2a)
    seq_shard: bool = False     # 2D fully-sharded activations
    vp_loss: bool = False       # vocab-parallel CE (no logit gathers)
    serve_rules: bool = False   # no-FSDP weight layout for decode
    weight_quant: str = "none"  # "int8": SNE-style low-bit decode weights
    sd_decode_frac: float = 0.0  # >0: sigma-delta event-gated decode
    # --- encoder-decoder / frontends ---
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None      # "audio" | "vision" | None
    n_patches: int = 0                  # vision stub: patches prepended
    # --- recurrent blocks ---
    conv1d_width: int = 4
    lru_width: int = 0          # 0 -> d_model
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    causal_fold: bool = False   # folded causal schedule (see attention.py)
    # --- training memory knobs ---
    grad_accum: int = 1         # microbatch accumulation steps
    grad_dtype: str = "float32"
    moment_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    def runs(self) -> Tuple[Tuple[LayerSpec, int], ...]:
        """Group consecutive identical LayerSpecs into (spec, count) runs."""
        out = []
        for spec in self.layers:
            if out and out[-1][0] == spec:
                out[-1] = (spec, out[-1][1] + 1)
            else:
                out.append((spec, 1))
        return tuple(out)

    def scan_groups(self) -> Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]:
        """The reference's (cycle, repeat) scan groups of the layer stack:
        the shortest cycle that repeats at least twice from the first
        layer, and the remainder as a group of its own."""
        layers = self.layers
        n = len(layers)
        for p in range(1, n + 1):
            k = n // p
            if k > 1 and tuple(layers[:p] * k) == tuple(layers[:p * k]):
                groups = [(tuple(layers[:p]), k)]
                rem = tuple(layers[p * k:])
                if rem:
                    groups.append((rem, 1))
                return tuple(groups)
        return ((tuple(layers), 1),)

    def validate(self) -> None:
        if len(self.layers) != self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layers)} layer specs "
                             f"!= {self.n_layers}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} heads are not a "
                             f"multiple of {self.n_kv_heads} kv heads")
        if any(l.ffn == FFN_MOE for l in self.layers) and not (
                self.n_experts > 0 and self.top_k > 0 and self.expert_ff > 0):
            raise ValueError(f"{self.name}: MoE layers need n_experts, "
                             f"top_k and expert_ff")
        if any(l.mixer == ATTN_LOCAL for l in self.layers) \
                and self.window <= 0:
            raise ValueError(f"{self.name}: local attention needs a window")
        if any(l.cross_attn for l in self.layers) and self.encoder is None:
            raise ValueError(f"{self.name}: cross attention needs an "
                             f"encoder")


def uniform_layers(n: int, mixer: str, ffn: str = FFN_DENSE,
                   cross: bool = False) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec(mixer, ffn, cross) for _ in range(n))


def pattern_layers(n: int, cycle: Tuple[LayerSpec, ...]
                   ) -> Tuple[LayerSpec, ...]:
    """Repeat ``cycle`` until ``n`` layers (truncating the last cycle)."""
    out = []
    while len(out) < n:
        out.extend(cycle)
    return tuple(out[:n])
