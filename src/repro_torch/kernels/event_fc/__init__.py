"""Event-fc kernels (slot-batched scatter and its single-stream face,
fused window): plain PyTorch versions and CUDA wrappers."""
from repro_torch.kernels.event_fc.ops import (event_fc, event_fc_batched,
                                              event_fc_window)
from repro_torch.kernels.event_fc.ref import (event_fc_batched_ref,
                                              event_fc_ref,
                                              event_fc_window_ref)

__all__ = ["event_fc", "event_fc_batched", "event_fc_batched_ref",
           "event_fc_ref", "event_fc_window", "event_fc_window_ref"]
