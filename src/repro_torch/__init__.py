"""PyTorch / CUDA port of the SNE event-domain serving stack.

The package mirrors the module names of the JAX reference (``repro``) so a
reader can find each counterpart: ``core/`` (policies, LIF dynamics, event
representation, layer specs, quantisation, the layer-program executor),
``kernels/`` (hand-written CUDA scatter kernels plus their plain PyTorch
twins), ``data/`` (DVS ingestion) and ``serve/`` (the slot-batched engine
and telemetry).  It never imports ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
