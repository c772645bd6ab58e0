"""olmoe-1b-7b [moe] — 64 experts, top-8, every layer MoE
[arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16) d_ff=1024 (expert width) vocab=50304.
~6.9B total / ~1.3B active.
"""
from repro_torch.models.config import (ATTN_GLOBAL, FFN_MOE, ModelConfig,
                                       uniform_layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
        vocab_size=50304,
        layers=uniform_layers(16, ATTN_GLOBAL, FFN_MOE),
        n_experts=64, top_k=8, expert_ff=1024, shared_expert=False,
        capacity_factor=1.25,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=512,
        layers=uniform_layers(2, ATTN_GLOBAL, FFN_MOE),
        n_experts=4, top_k=2, expert_ff=64, shared_expert=False,
        attn_chunk_q=64, attn_chunk_kv=64, remat=False, dtype="float32",
    )
