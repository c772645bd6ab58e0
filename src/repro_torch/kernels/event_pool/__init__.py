"""Event-pool kernels (slot-batched scatter and its single-stream face,
fused window): plain PyTorch versions and CUDA wrappers."""
from repro_torch.kernels.event_pool.ops import (event_pool,
                                                event_pool_batched,
                                                event_pool_window)
from repro_torch.kernels.event_pool.ref import (event_pool_batched_ref,
                                                event_pool_ref,
                                                event_pool_window_ref)

__all__ = ["event_pool", "event_pool_batched", "event_pool_batched_ref",
           "event_pool_ref", "event_pool_window", "event_pool_window_ref"]
