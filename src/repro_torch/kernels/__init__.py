"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

Each kernel package (``event_conv``, ``event_pool``, ``event_fc``,
``network_window``, ``lif``) keeps the reference's split: ``ref.py`` is
the plain PyTorch version (a loop over events, vectorised over slots) and
``ops.py`` the wrapper, which runs the plain version for CPU tensors and
launches the CUDA kernel
(``csrc/*.cu``, built by `kernels._build`) for CUDA tensors — never a
quiet fallback.  Every launch is counted in
:data:`repro_torch.kernels._common.LAUNCHES`.
"""
from repro_torch.kernels._common import LAUNCHES, reset_launch_counts

__all__ = ["LAUNCHES", "reset_launch_counts"]
