"""Modality frontend stubs, counterpart of ``repro.models.frontend``.

The audio and vision architectures specify the transformer backbone only;
their inputs are precomputed frame or patch embeddings.  The stub is the
single linear projection that adapts those features to ``d_model`` (where
whisper's conv frontend or InternViT's connector would sit).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DeclTree, ParamDecl, ParamTree


def frontend_decls(cfg: ModelConfig) -> Optional[DeclTree]:
    """The projection from the precomputed feature width to ``d_model``:
    audio ``d_input -> d_model``, vision ``d_model -> d_model``."""
    if cfg.frontend == "audio":
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name}: the audio frontend feeds an "
                             f"encoder, and the config has none")
        return {"proj": ParamDecl((cfg.encoder.d_input, cfg.d_model),
                                  (None, "p_embed"), dtype=cfg.tdtype)}
    if cfg.frontend == "vision":
        return {"proj": ParamDecl((cfg.d_model, cfg.d_model),
                                  ("p_embed", None), dtype=cfg.tdtype)}
    return None


def apply_frontend(p: ParamTree, cfg: ModelConfig,
                   feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, n, d_in) precomputed embeddings -> (B, n, d_model) in
    ``feats``' dtype."""
    return feats @ p["proj"].to(feats.dtype)


def frontend_feature_shape(cfg: ModelConfig,
                           batch: int) -> Optional[Tuple[int, int, int]]:
    """The shape of the stub inputs for ``batch`` rows (None without a
    frontend)."""
    if cfg.frontend == "audio":
        return (batch, cfg.encoder.n_frames, cfg.encoder.d_input)
    if cfg.frontend == "vision":
        return (batch, cfg.n_patches, cfg.d_model)
    return None
