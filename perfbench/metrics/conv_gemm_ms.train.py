"""Device ms per training step in convolution and GEMM kernels, by kernel
name (cuBLAS and CUTLASS GEMMs, im2col and col2im of PyTorch's own
convolution, which ``dense_math`` runs with cuDNN off)."""
NAME, UNIT, LAYER = "conv_gemm_ms.train", "ms", "train step"
MOVES, TRACED = "train_samples_per_s", True
PATTERNS = ("gemm", "cutlass", "nvjet", "xmma", "im2col", "col2im", "conv")


def read(r):
    """The metric from a run's readings; None where there is none."""
    n = r["steps"]
    if not n:
        return None
    s = r["trace"].device_s(lambda k: any(p in k.lower() for p in PATTERNS))
    return 1e3 * s / n if s > 0 else None
