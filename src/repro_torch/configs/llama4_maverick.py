"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE, shared expert,
dense/MoE interleave [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Alternating dense/MoE FFN layers (Llama-4's interleave_moe_layer_step=2)
lands the family at ~400B total / ~17B active parameters:
  24 MoE layers x 128 experts x 3 x 5120 x 8192  = 386.5B   (routed)
  24 shared-expert + 24 dense FFN + 48 attn + embed ~= 11B
SNE tie-in (DESIGN.md §5): top-1 routing is token-level event gating —
compute is proportional to routed "token events"; static expert capacity is
the event-FIFO analogue (overflow dropped AND counted).
"""
from repro_torch.models.config import (ATTN_GLOBAL, FFN_DENSE, FFN_MOE,
                                       LayerSpec, ModelConfig, pattern_layers)

_CYCLE = (LayerSpec(ATTN_GLOBAL, FFN_DENSE), LayerSpec(ATTN_GLOBAL, FFN_MOE))


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048,
        layers=pattern_layers(48, _CYCLE),
        n_experts=128, top_k=1, expert_ff=8192, shared_expert=True,
        capacity_factor=1.25,
        rope_theta=500000.0,
        # 400B-class: bf16 moments keep optimizer state inside 16 GB/chip
        # (recorded in DESIGN.md §6; f32 master-moment variant is a flag).
        moment_dtype="bfloat16", grad_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        layers=pattern_layers(2, _CYCLE),
        n_experts=4, top_k=1, expert_ff=256, shared_expert=True,
        attn_chunk_q=64, attn_chunk_kv=64, remat=False, dtype="float32",
    )
