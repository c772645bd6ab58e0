"""The sequence loop of the xLSTM blocks, with the dry-run's analysis
switch: the counterpart of ``repro.models.scan_util.xscan_seq``.

The reference scans the xLSTM recurrence with ``xscan_seq``, a scan that
its analysis lowering does not unroll, so XLA's cost analysis counts its
body once and the dry-run adds the rest analytically
(``launch.dryrun._recurrence_flops``).  :func:`seq_loop` is the port's
loop; under :func:`analysis` (which the dry-run opens) it runs one step,
for the shapes and the body's count, and returns outputs of the full
length, so a 32k-step recurrence is not a million meta ops.  Outside the
switch it is the plain per-timestep loop.

The reference's other switch, ``unrolled`` (``xscan`` unrolled for the
analysis lowering, because XLA counts a while body once), has no
counterpart: the port's layer, attention-chunk and loss-chunk loops are
Python loops, so a FLOP counter sees every iteration.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch

_STATE = {"analysis": False}


@contextlib.contextmanager
def analysis():
    """Turn the analysis switch on for the block's duration."""
    prev = _STATE["analysis"]
    _STATE["analysis"] = True
    try:
        yield
    finally:
        _STATE["analysis"] = prev


def seq_loop(step: Callable, state, length: int) -> Tuple[object,
                                                           torch.Tensor]:
    """``state, h_t = step(t, state)`` for ``t`` in ``range(length)``;
    returns the last state and the outputs stacked on dim 1.  Under the
    analysis switch only step 0 runs, and its output stands for every
    step (expanded to ``length`` on dim 1)."""
    if _STATE["analysis"]:
        state, h = step(0, state)
        return state, h.unsqueeze(1).expand(h.shape[0], length,
                                            *h.shape[1:])
    hs = []
    for t in range(length):
        state, h = step(t, state)
        hs.append(h)
    return state, torch.stack(hs, 1)
