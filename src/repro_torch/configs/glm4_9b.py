"""glm4-9b [dense] — RoPE, aggressive GQA (kv=2) [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.models.config import (ATTN_GLOBAL, FFN_DENSE, ModelConfig,
                                       uniform_layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
        vocab_size=151552,
        layers=uniform_layers(40, ATTN_GLOBAL, FFN_DENSE),
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, d_ff=256,
        vocab_size=512,
        layers=uniform_layers(2, ATTN_GLOBAL, FFN_DENSE),
        attn_chunk_q=64, attn_chunk_kv=64, remat=False, dtype="float32",
    )
