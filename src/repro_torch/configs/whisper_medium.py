"""whisper-medium [audio] — enc-dec; conv frontend STUBBED per assignment
[arXiv:2212.04356; unverified].

24+24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. The backbone is the
transformer; ``input_specs()`` provides precomputed (B, 1500, 80) mel-frame
features and the stub is the linear 80 -> d_model projection (where the two
conv layers would sit). Decoder layers cross-attend to the encoder output.
"""
from repro_torch.models.config import (ATTN_GLOBAL, EncoderConfig, FFN_DENSE,
                                       LayerSpec, ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab_size=51865,
        layers=tuple(LayerSpec(ATTN_GLOBAL, FFN_DENSE, cross_attn=True)
                     for _ in range(24)),
        encoder=EncoderConfig(n_layers=24, n_frames=1500, d_input=80),
        frontend="audio", pos_emb="sinusoidal", act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        layers=tuple(LayerSpec(ATTN_GLOBAL, FFN_DENSE, cross_attn=True)
                     for _ in range(2)),
        encoder=EncoderConfig(n_layers=2, n_frames=32, d_input=16),
        frontend="audio", pos_emb="sinusoidal", act="gelu",
        attn_chunk_q=32, attn_chunk_kv=32, remat=False, dtype="float32",
    )
