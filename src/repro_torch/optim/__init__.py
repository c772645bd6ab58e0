"""Optimizers and learning-rate schedules, counterpart of ``repro.optim``."""
from repro_torch.optim.optimizers import (AdamWState, SgdState, adamw_init,
                                          adamw_update, clip_by_global_norm,
                                          sgd_init, sgd_update)
from repro_torch.optim.schedules import (constant, cosine_decay, linear_warmup,
                                         warmup_cosine)

__all__ = [
    "AdamWState", "SgdState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "sgd_init", "sgd_update",
    "constant", "cosine_decay", "linear_warmup", "warmup_cosine",
]
