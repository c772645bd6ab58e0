"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.models.config import (ATTN_GLOBAL, FFN_DENSE, ModelConfig,
                                       uniform_layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=49152,
        layers=uniform_layers(36, ATTN_GLOBAL, FFN_DENSE),
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        layers=uniform_layers(3, ATTN_GLOBAL, FFN_DENSE),
        attn_chunk_q=64, attn_chunk_kv=64, remat=False, dtype="float32",
    )
