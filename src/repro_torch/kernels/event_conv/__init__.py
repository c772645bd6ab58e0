"""Event-conv kernels (slot-batched scatter and its single-stream face,
fused window): plain PyTorch versions and CUDA wrappers."""
from repro_torch.kernels.event_conv.ops import (event_conv,
                                                event_conv_batched,
                                                event_conv_window)
from repro_torch.kernels.event_conv.ref import (event_conv_batched_ref,
                                                event_conv_ref,
                                                event_conv_window_ref)

__all__ = ["event_conv", "event_conv_batched", "event_conv_batched_ref",
           "event_conv_ref", "event_conv_window", "event_conv_window_ref"]
