"""internvl2-26b [vlm] — InternViT (stub) + InternLM2-20B backbone
[arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The ViT frontend is
STUBBED per assignment: ``input_specs()`` provides 256 precomputed patch
embeddings (InternViT-6B after pixel-unshuffle) which overwrite the first
256 token positions (VLM prefix); the stub connector MLP is the only
frontend parameter.
"""
from repro_torch.models.config import (ATTN_GLOBAL, FFN_DENSE, ModelConfig,
                                       uniform_layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab_size=92553,
        layers=uniform_layers(48, ATTN_GLOBAL, FFN_DENSE),
        frontend="vision", n_patches=256,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        layers=uniform_layers(2, ATTN_GLOBAL, FFN_DENSE),
        frontend="vision", n_patches=8,
        attn_chunk_q=32, attn_chunk_kv=32, remat=False, dtype="float32",
    )
