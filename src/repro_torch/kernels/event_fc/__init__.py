"""Slot-batched event-fc scatter: plain PyTorch version and CUDA wrapper."""
from repro_torch.kernels.event_fc.ops import event_fc_batched
from repro_torch.kernels.event_fc.ref import event_fc_batched_ref

__all__ = ["event_fc_batched", "event_fc_batched_ref"]
