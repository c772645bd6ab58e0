"""gemma3-1b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
sliding window 512, tied embeddings.
"""
from repro_torch.models.config import (ATTN_GLOBAL, ATTN_LOCAL, FFN_DENSE,
                                       LayerSpec, ModelConfig,
                                       pattern_layers)

_CYCLE = tuple([LayerSpec(ATTN_LOCAL, FFN_DENSE)] * 5
               + [LayerSpec(ATTN_GLOBAL, FFN_DENSE)])


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
        vocab_size=262144, head_dim=256, window=512,
        layers=pattern_layers(26, _CYCLE),
        tie_embeddings=True, act="gelu", rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=2, n_kv_heads=1, d_ff=192,
        vocab_size=512, head_dim=48, window=16,
        layers=pattern_layers(3, (LayerSpec(ATTN_LOCAL, FFN_DENSE),
                                  LayerSpec(ATTN_LOCAL, FFN_DENSE),
                                  LayerSpec(ATTN_GLOBAL, FFN_DENSE))),
        tie_embeddings=True, act="gelu",
        attn_chunk_q=32, attn_chunk_kv=32, remat=False, dtype="float32",
    )
