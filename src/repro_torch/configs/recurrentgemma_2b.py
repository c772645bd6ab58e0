"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 2:1
[arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, lru_width=2560,
window=2048. Pattern: (rglru, rglru, local-attn) repeating.

The RG-LRU gated leaky integrator is the same dynamical family as the
SNE paper's LIF membrane; its lazy update surfaces in decode as
sigma-delta event-gated matvecs (``core/sd_decode.py``).
"""
from repro_torch.models.config import (ATTN_LOCAL, FFN_DENSE, RGLRU,
                                       LayerSpec, ModelConfig,
                                       pattern_layers)

_CYCLE = (LayerSpec(RGLRU, FFN_DENSE), LayerSpec(RGLRU, FFN_DENSE),
          LayerSpec(ATTN_LOCAL, FFN_DENSE))


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
        vocab_size=256000, window=2048, lru_width=2560, conv1d_width=4,
        layers=pattern_layers(26, _CYCLE),
        tie_embeddings=True, act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", family="hybrid",
        n_layers=3, d_model=128, n_heads=2, n_kv_heads=1, d_ff=256,
        vocab_size=512, window=16, lru_width=128, conv1d_width=4,
        layers=pattern_layers(3, _CYCLE),
        tie_embeddings=True, act="gelu",
        attn_chunk_q=32, attn_chunk_kv=32, remat=False, dtype="float32",
    )
