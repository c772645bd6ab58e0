"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 7:1 m:s ratio
[arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 (blocks carry their own projections)
vocab=50304. Blocks are exponential-gated leaky integrators — the closest
assigned relative of the paper's LIF dynamics (DESIGN.md §5).
"""
from repro_torch.models.config import (FFN_NONE, LayerSpec, MLSTM, ModelConfig,
                                       SLSTM, pattern_layers)

_CYCLE = tuple([LayerSpec(MLSTM, FFN_NONE)] * 7 + [LayerSpec(SLSTM, FFN_NONE)])


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304,
        layers=pattern_layers(48, _CYCLE),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
        vocab_size=512,
        layers=pattern_layers(3, (LayerSpec(MLSTM, FFN_NONE),
                                  LayerSpec(MLSTM, FFN_NONE),
                                  LayerSpec(SLSTM, FFN_NONE))),
        tie_embeddings=True, remat=False, dtype="float32",
    )
