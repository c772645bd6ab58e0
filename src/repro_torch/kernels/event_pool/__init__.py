"""Slot-batched event-pool scatter: plain PyTorch version and CUDA wrapper."""
from repro_torch.kernels.event_pool.ops import event_pool_batched
from repro_torch.kernels.event_pool.ref import event_pool_batched_ref

__all__ = ["event_pool_batched", "event_pool_batched_ref"]
