"""deepseek-7b [dense] — llama-arch, MHA (kv == heads) [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.models.config import (ATTN_GLOBAL, FFN_DENSE, ModelConfig,
                                       uniform_layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
        vocab_size=102400,
        layers=uniform_layers(30, ATTN_GLOBAL, FFN_DENSE),
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        layers=uniform_layers(2, ATTN_GLOBAL, FFN_DENSE),
        attn_chunk_q=64, attn_chunk_kv=64, remat=False, dtype="float32",
    )
