"""Slot-batched event-conv scatter: plain PyTorch version and CUDA wrapper."""
from repro_torch.kernels.event_conv.ops import event_conv_batched
from repro_torch.kernels.event_conv.ref import event_conv_batched_ref

__all__ = ["event_conv_batched", "event_conv_batched_ref"]
