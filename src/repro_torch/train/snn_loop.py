"""Surrogate-gradient training through the layer-program executor.

Counterpart of ``repro.train.snn_loop``.  The forward is
`core.layer_program.dense_program_forward`, the compiled op chain the
serving engine executes, with the fire routed through `core.lif.spike_fn`'s
fast-sigmoid surrogate so autograd backpropagates through time.
``qat=True`` fake-quantises conv/fc weights onto the int4 deployment grid
with straight-through gradients, so `core.quant.quantize_net` expresses
the trained weights exactly.

* :func:`batch_loss` — mean rate-decoded loss of a batch (cross-entropy or
  the SLAYER spike-count target, `core.sne_net`);
* :func:`make_train_step` — one step: loss and gradients, pool gradients
  zeroed, then `optim/`'s AdamW or momentum SGD under a warmup-cosine
  schedule read off the optimizer's step counter, pool weights pinned;
* :func:`fit` — the host loop: the data cursor is the step index
  (`data.events_ds.batch_at` is pure in ``(seed, index)`` on a device),
  optional real-recording windows mixed in, atomic checkpoint / resume
  (`train/checkpoint.py`; the resumed run is bitwise the uninterrupted
  one on the same device), preemption and straggler hooks
  (`train/fault.py`);
* :func:`evaluate` — accuracy of the inference-mode forward on a
  held-out cohort;
* :func:`save_net` / :func:`load_net` (from `repro_torch.weights`) — the
  single-file ``.npz`` artifact both packages read; :func:`load_trained_tiny`
  loads the bundled trained tiny-gesture net.

Every step runs inside `core.econv.dense_math` (cuDNN off, float32
convolutions and matmuls, deterministic algorithms) and on one device;
:func:`fit` and :func:`evaluate` default to CUDA like every entry point of
the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.econv import EConvParams, dense_math
from repro_torch.core.layer_program import (LayerProgram, compile_program,
                                            dense_program_forward)
from repro_torch.core.sne_net import (SNNSpec, ce_loss, count_loss, init_snn,
                                      predict, tiny_net)
from repro_torch.data.events_ds import (EventDatasetSpec, batch_at,
                                        sample_recording_path)
from repro_torch.device import resolve_device
from repro_torch.optim import (adamw_init, adamw_update, sgd_init,
                               sgd_update, warmup_cosine)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import (PreemptionGuard, StepWatchdog,
                                     with_retries)
from repro_torch.weights import load_net, save_net

__all__ = ["TrainConfig", "batch_loss", "init_opt", "make_train_step",
           "FitResult", "fit", "evaluate", "save_net", "load_net",
           "trained_net_path", "load_trained_tiny"]

LOSSES = ("ce", "count")
OPTIMIZERS = ("adamw", "sgd")
TRAINED_TINY_NAME = "tiny_gesture_trained.npz"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One surrogate-gradient training run, fully determined: every field
    feeds the step or the deterministic data cursor."""

    steps: int = 100
    batch: int = 8
    lr: float = 3e-3
    seed: int = 0
    qat: bool = False
    loss: str = "ce"            # "ce" | "count"
    optimizer: str = "adamw"    # "adamw" | "sgd"
    weight_decay: float = 0.0
    warmup_frac: float = 0.1    # fraction of steps spent in warmup

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"unknown loss {self.loss!r} "
                             f"(expected one of {LOSSES})")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r} "
                             f"(expected one of {OPTIMIZERS})")
        if self.steps <= 0 or self.batch <= 0:
            raise ValueError("steps and batch must be positive")


def batch_loss(program: LayerProgram, params: Sequence[EConvParams],
               spikes: torch.Tensor, labels: torch.Tensor,
               qat: bool = False, loss: str = "ce") -> torch.Tensor:
    """Mean rate-decoded loss of a ``(B, T, H, W, C)`` batch (the mean of
    the per-sample losses, as the reference's ``vmap``)."""
    out, _ = dense_program_forward(program, list(params), spikes,
                                   train=True, qat=qat)
    per = (count_loss(out, labels, program.spec) if loss == "count"
           else ce_loss(out, labels))
    return per.mean()


def init_opt(params: Sequence[EConvParams], cfg: TrainConfig):
    """Optimizer state for ``cfg.optimizer`` over the layers' weights."""
    ws = [p.w for p in params]
    return adamw_init(ws) if cfg.optimizer == "adamw" else sgd_init(ws)


def make_train_step(program: LayerProgram, cfg: TrainConfig):
    """The step: ``(params, opt, spikes, labels) -> (params, opt,
    metrics)`` with ``metrics = {"loss", "lr"}`` (+ ``"grad_norm"`` under
    AdamW), all tensors on the batch's device.

    Pool layers carry unit synapses on the integer datapath: their
    gradients are zeroed before the update (so before the global-norm
    clip) and their weights pinned after it, so weight decay cannot drift
    them either.
    """
    sched = warmup_cosine(cfg.lr, max(int(cfg.steps * cfg.warmup_frac), 1),
                          cfg.steps)
    frozen = tuple(op.kind == "pool" for op in program.ops)

    def step(params, opt, spikes, labels):
        leaves = [p.w.detach().requires_grad_() for p in params]
        with dense_math():
            lval = batch_loss(program, [EConvParams(w=w) for w in leaves],
                              spikes, labels, qat=cfg.qat, loss=cfg.loss)
            grads = torch.autograd.grad(lval, leaves)
        grads = [torch.zeros_like(g) if f else g
                 for g, f in zip(grads, frozen)]
        lr = sched(opt.step)
        ws = [p.w for p in params]
        if cfg.optimizer == "adamw":
            new, opt, om = adamw_update(grads, opt, ws, lr,
                                        weight_decay=cfg.weight_decay)
        else:
            new, opt, om = sgd_update(grads, opt, ws, lr)
        params = [old if f else EConvParams(w=w)
                  for old, w, f in zip(params, new, frozen)]
        metrics = dict(om)
        metrics["loss"] = lval.detach()
        metrics["lr"] = lr
        return params, opt, metrics

    return step


class FitResult(NamedTuple):
    """What :func:`fit` hands back to the caller."""

    params: List[EConvParams]
    losses: np.ndarray          # float32, one entry per executed step
    start_step: int             # 0, or the checkpoint-resume point
    wall_time_s: float
    step_s: np.ndarray          # each executed step's wall time (s)


def fit(spec: SNNSpec, ds: EventDatasetSpec, cfg: TrainConfig, *,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        recording: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        log_every: int = 0, log_fn: Callable[[str], None] = print,
        device=None) -> FitResult:
    """Train ``spec`` on the synthetic stream (+ optional real windows) on
    ``device`` (default: CUDA).

    Weights start from ``init_snn(numpy default_rng(cfg.seed))``.  The
    data cursor is the step index, so checkpoint resume replays nothing
    and the resumed loss curve is bitwise the uninterrupted one.
    ``recording`` is an optional ``(spikes (S, T, H, W, C), labels (S,))``
    pair (`data.events_ds.recording_dense_windows`), mixed in by replacing
    the last sample of step ``i``'s batch with window ``i % S``.
    """
    dev = resolve_device(device)
    program = compile_program(spec, device=dev)
    params = init_snn(np.random.default_rng(cfg.seed), spec, device=dev)
    opt = init_opt(params, cfg)
    start = 0
    if ckpt_dir:
        last = ckpt_lib.latest(ckpt_dir)
        if last is not None:
            (params, opt), extras = ckpt_lib.restore(ckpt_dir, last,
                                                     (params, opt))
            start = extras.get("next_step", last)
            log_fn(f"[snn] restored step {last} -> resuming at {start}")
    if recording is not None:
        rec_spikes, rec_labels = (t.to(dev) for t in recording)
        if int(rec_spikes.shape[0]) == 0:
            raise ValueError("recording mix needs at least one window")

    step_fn = make_train_step(program, cfg)
    guard, watchdog = PreemptionGuard(), StepWatchdog()
    losses: List[float] = []
    step_s: List[float] = []
    t_begin = time.time()
    for i in range(start, cfg.steps):
        spikes, labels = batch_at(cfg.seed, i, cfg.batch, ds, device=dev)
        if recording is not None:
            j = i % int(rec_spikes.shape[0])
            spikes[cfg.batch - 1] = rec_spikes[j]
            labels[cfg.batch - 1] = rec_labels[j]
        watchdog.start()
        params, opt, metrics = step_fn(params, opt, spikes, labels)
        lval = float(metrics["loss"])
        dt = watchdog.stop(i)
        losses.append(lval)
        step_s.append(dt)
        if log_every and (i % log_every == 0 or i == cfg.steps - 1):
            log_fn(f"[snn] step {i:4d} loss {lval:.4f} "
                   f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms")
        want_ckpt = ckpt_dir and ((i + 1) % ckpt_every == 0
                                  or i == cfg.steps - 1 or guard.requested)
        if want_ckpt:
            with_retries(lambda: ckpt_lib.save(
                ckpt_dir, i + 1, (params, opt),
                extras={"next_step": i + 1}))
        if guard.requested:
            log_fn(f"[snn] preemption requested; checkpointed at "
                   f"step {i + 1}, exiting cleanly")
            break
    guard.restore()
    return FitResult(params=params, losses=np.asarray(losses, np.float32),
                     start_step=start, wall_time_s=time.time() - t_begin,
                     step_s=np.asarray(step_s))


@torch.no_grad()
def evaluate(spec: SNNSpec, params: Sequence[EConvParams],
             ds: EventDatasetSpec, n: int = 32, seed: int = 1,
             qat: bool = False, cohort: int = 10 ** 6, device=None) -> float:
    """Eval accuracy of the inference-mode program forward on a held-out
    cohort: ``(seed, cohort)`` index a `batch_at` batch disjoint from the
    training cursors.  Runs on ``device`` (default: CUDA), where
    ``params`` must already be."""
    dev = resolve_device(device)
    program = compile_program(spec, device=dev)
    spikes, labels = batch_at(seed, cohort, n, ds, device=dev)
    out, _ = dense_program_forward(program, list(params), spikes,
                                   train=False, qat=qat)
    return float((predict(out) == labels).to(torch.float32).mean())


def trained_net_path(name: str = TRAINED_TINY_NAME) -> str:
    """Path of the bundled trained checkpoint (committed artifact)."""
    return sample_recording_path(name)


def load_trained_tiny(device=None) -> Tuple[SNNSpec, List[EConvParams],
                                            dict]:
    """The bundled trained tiny-gesture net ``(spec, params, meta)``, the
    params on ``device`` (default: CUDA)."""
    spec = tiny_net()
    params, meta = load_net(trained_net_path(), spec, device=device)
    return spec, params, meta
