"""The fused-network window megakernel: plain PyTorch version and CUDA
wrapper."""
from repro_torch.kernels.network_window.ops import (CLUSTER, SMEM_BUDGET,
                                                    network_window,
                                                    smem_layout)
from repro_torch.kernels.network_window.ref import network_window_ref
from repro_torch.kernels.network_window.spec import NetLayer

__all__ = ["CLUSTER", "NetLayer", "SMEM_BUDGET", "network_window",
           "network_window_ref", "smem_layout"]
