"""LM training: the train step with gradient accumulation, and the host
loop with checkpoints and fault hooks; counterpart of
``repro.train.loop``.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss (``models.transformer.lm_loss``), its
gradients by autograd over the parameter tree's leaves, then AdamW.  The
parameter tree is the port's dict (``models.layers.tree_leaves`` order);
the optimizer state is an ``AdamWState`` whose moments are trees of the
same shape in ``cfg.moment_dtype``.  ``train_loop`` is the host loop:
restore-if-present, step, checkpoint, SIGTERM, straggler accounting.

Nothing here is compiled: each step runs eagerly, its loss and its
gradients on the device of the parameters.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import ParamTree, tree_leaves, tree_unflatten
from repro_torch.models.transformer import init_model, lm_loss
from repro_torch.optim.optimizers import AdamWState, adamw_init, adamw_update
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import PreemptionGuard, StepWatchdog, with_retries

Batch = Dict[str, torch.Tensor]


def make_loss_fn(cfg: ModelConfig, loss_chunk: int = 512):
    """``(params, batch) -> (loss, metrics)``: ``lm_loss`` of the batch's
    ``tokens`` and ``labels`` (and its ``frames`` / ``patches``)."""
    def loss_fn(params: ParamTree, batch: Batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       frames=batch.get("frames"),
                       patches=batch.get("patches"), loss_chunk=loss_chunk)
    return loss_fn


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves(tree)]


def loss_and_grads(loss_fn: Callable, params: ParamTree, batch: Batch):
    """``loss_fn(params, batch)`` under autograd: the loss and its metrics
    (detached), and the loss's gradients with respect to every leaf of
    ``params``, in ``tree_leaves`` order."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def make_train_step(cfg: ModelConfig, lr_schedule: Callable,
                    loss_chunk: int = 512,
                    max_grad_norm: Optional[float] = 1.0,
                    weight_decay: float = 0.1):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``cfg.grad_accum > 1`` splits the batch into that many microbatches,
    run one after the other, their gradients accumulated as ``g_acc +
    g / accum`` in ``cfg.grad_dtype`` (activations live for one microbatch
    only); the loss is ``Σ l / accum`` and the other metrics are the last
    microbatch's.  The metrics are 0-d tensors: the loss's (``ce``,
    ``aux_loss``, ``moe_dropped``, ``tokens``), ``grad_norm`` (before
    clipping), ``loss`` and ``lr``.  Nothing is updated in place."""
    loss_fn = make_loss_fn(cfg, loss_chunk)
    accum = max(cfg.grad_accum, 1)
    acc_dtype = torch_dtype(cfg.grad_dtype)

    def train_step(params: ParamTree, opt_state: AdamWState, batch: Batch):
        leaves = _leaves(params)
        if accum == 1:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, metrics, g = loss_and_grads(loss_fn, params, mb)
                grads = [a + b.to(acc_dtype) / accum
                         for a, b in zip(grads, g)]
                loss = loss + l / accum
        lr = lr_schedule(opt_state.step)
        state = AdamWState(opt_state.step, _leaves(opt_state.mu),
                           _leaves(opt_state.nu))
        new_p, state, om = adamw_update(
            grads, state, leaves, lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return (tree_unflatten(params, new_p),
                AdamWState(state.step, tree_unflatten(params, state.mu),
                           tree_unflatten(params, state.nu)), metrics)

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig, device=None
                     ) -> Tuple[ParamTree, AdamWState]:
    """Random parameters drawn from ``gen`` (a generator on ``device``;
    default: the CUDA device, raising without one) and zero AdamW moments
    of the same tree in ``cfg.moment_dtype``."""
    params = init_model(gen, cfg, resolve_device(device))
    st = adamw_init(_leaves(params), torch_dtype(cfg.moment_dtype))
    return params, AdamWState(st.step, tree_unflatten(params, st.mu),
                              tree_unflatten(params, st.nu))


def train_loop(cfg: ModelConfig, batches: Iterator[Batch], n_steps: int,
               lr_schedule: Callable, *, seed: int = 0,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
               log_every: int = 10, loss_chunk: int = 512,
               log_fn: Callable[[str], None] = print,
               device=None) -> Dict[str, Any]:
    """The host loop: restore-if-present, step, checkpoint, handle SIGTERM.

    The parameters are drawn from ``torch.Generator(device)`` seeded
    ``seed`` (default device: CUDA), then replaced by the newest
    checkpoint in ``ckpt_dir`` if there is one; ``batches`` must then
    start at the checkpoint's ``next_step``.  Checkpoints are written every
    ``ckpt_every`` steps, at the last step and when SIGTERM arrived (after
    which the loop stops).  Returns ``{"params", "opt_state", "history"``
    (one dict of float metrics and ``step_time_s`` a step) ``,
    "stragglers", "wall_time_s"}``."""
    dev = resolve_device(device)
    params, opt_state = init_train_state(
        torch.Generator(dev).manual_seed(seed), cfg, dev)
    start = 0
    if ckpt_dir:
        last = ckpt_lib.latest(ckpt_dir)
        if last is not None:
            (params, opt_state), extras = ckpt_lib.restore(
                ckpt_dir, last, (params, opt_state))
            start = extras.get("next_step", last)
            log_fn(f"[train] restored step {last} -> resuming at {start}")

    step_fn = make_train_step(cfg, lr_schedule, loss_chunk)
    guard = PreemptionGuard()
    watchdog = StepWatchdog()
    history = []
    t_begin = time.time()
    for step in range(start, n_steps):
        batch = next(batches)
        watchdog.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = watchdog.stop(step)
        metrics["step_time_s"] = dt
        history.append(metrics)
        if step % log_every == 0 or step == n_steps - 1:
            log_fn(f"[train] step {step:5d} loss {metrics['loss']:.4f} "
                   f"lr {metrics['lr']:.2e} {dt*1e3:.0f} ms")
        want_ckpt = ckpt_dir and (
            (step + 1) % ckpt_every == 0 or step == n_steps - 1
            or guard.requested)
        if want_ckpt:
            with_retries(lambda: ckpt_lib.save(
                ckpt_dir, step + 1, (params, opt_state),
                extras={"next_step": step + 1, "data_cursor": step + 1}))
        if guard.requested:
            log_fn(f"[train] preemption requested; checkpointed at "
                   f"step {step + 1}, exiting cleanly")
            break
    guard.restore()
    return {"params": params, "opt_state": opt_state, "history": history,
            "stragglers": watchdog.events,
            "wall_time_s": time.time() - t_begin}
