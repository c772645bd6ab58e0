"""The fused LIF boundary kernel: plain PyTorch version and CUDA wrapper."""
from repro_torch.kernels.lif.ops import lif_fused
from repro_torch.kernels.lif.ref import lif_fused_ref

__all__ = ["lif_fused", "lif_fused_ref"]
