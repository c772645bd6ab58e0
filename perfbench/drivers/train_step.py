"""Surrogate-gradient training of an eCNN through the port's step function
(``train.snn_loop.make_train_step``: QAT, AdamW), fed batches made on the
device from the seed.

Set-up builds the step with its weights and optimizer state, drives it
through the mix's first steps (``check_steps``) on batches 0, 1, 2, ...,
and hands the same objects to the window, which runs on from the next
batch.  ``train_samples_per_s`` is the batch times the steps whose loss
was read back inside the window, over the window's wall time.  A traced
run traces the mix's first ``trace_steps`` steps of the window.

After the window the plain reference repeats the first steps from the
same weights on the same batches.  Compared: each step's loss; by the
worst layer, the norm of the first gradient as the optimizer took it
(worked out from its first moment after one step) and the norm of the
weights' change over the first steps.  Layers whose reference gradient is
under a thousandth of the median layer's (the frozen pool synapses) are
left out of both.
"""
from __future__ import annotations

import gc
import sys

import numpy as np

from perfbench import inputs
from perfbench.core import Outcome, Spans
from perfbench.program import snn_spec
from perfbench.reference import ecnn
from perfbench.trace import DeviceTrace


def optimizer_settings(mix: dict) -> dict:
    """The AdamW recipe of ``make_train_step`` as the reference takes it."""
    o = mix["optimizer"]
    return {"lr": o["lr"], "b1": 0.9, "b2": 0.95, "eps": 1e-8,
            "weight_decay": o["weight_decay"], "max_grad_norm": 1.0,
            "warmup": max(int(o["schedule_steps"] * o["warmup_frac"]), 1),
            "total": o["schedule_steps"]}


def worst_leaf_gap(got, want, keep) -> float:
    """Largest gap between the program's and the reference's norm of a
    kept layer, over the larger of that layer's reference norm and the
    median kept layer's."""
    g = [float(np.linalg.norm(a)) for a in got]
    w = [float(np.linalg.norm(b)) for b in want]
    med = float(np.median([w[i] for i in keep]))
    return max(abs(g[i] - w[i]) / max(w[i], med) for i in keep)


def judge(program: dict, ref: dict, limits: dict) -> dict:
    """The compared numbers, each beside its limit."""
    lp, lr = np.asarray(program["losses"]), np.asarray(ref["losses"])
    want_g = [g.cpu().numpy() for g in ref["first_grad"]]
    norms = [float(np.linalg.norm(g)) for g in want_g]
    med = float(np.median(norms))
    keep = [i for i, n in enumerate(norms) if n >= 1e-3 * med]
    w0 = program["w0"]
    d_got = [a - b for a, b in zip(program["w_after"], w0)]
    d_want = [w.cpu().numpy() - b for w, b in zip(ref["weights"], w0)]
    return {
        "loss_gap": (float(np.max(np.abs(lp - lr) / np.abs(lr))),
                     limits["loss_gap"]),
        "first_grad_gap": (worst_leaf_gap(program["first_grad"], want_g,
                                          keep), limits["first_grad_gap"]),
        "change_gap": (worst_leaf_gap(d_got, d_want, keep),
                       limits["change_gap"]),
    }


def run(ctx) -> Outcome:
    """One run of a training cell."""
    import torch
    from repro_torch.core.econv import EConvParams
    from repro_torch.core.layer_program import compile_program
    from repro_torch.train.snn_loop import (TrainConfig, init_opt,
                                            make_train_step)
    cfg, mix, dev, clock = ctx.config, ctx.mix, ctx.device, ctx.clock
    t_enter = clock()
    B, data = mix["batch"], mix["data"]
    o = mix["optimizer"]
    layers = inputs.layer_shapes(cfg)
    w0 = inputs.make_weights(cfg, ctx.seed, dev)
    tcfg = TrainConfig(steps=o["schedule_steps"], batch=B, lr=o["lr"],
                       qat=True, loss="ce", optimizer="adamw",
                       weight_decay=o["weight_decay"],
                       warmup_frac=o["warmup_frac"])
    step = make_train_step(compile_program(snn_spec(cfg), device=dev), tcfg)
    params = [EConvParams(w=w.clone()) for w in w0]
    opt = init_opt(params, tcfg)
    spans = Spans(clock)
    t_built = clock()

    def one(i):
        nonlocal params, opt
        with spans.span("feed"):
            spikes, labels = inputs.dvs_batch(ctx.seed, i, B, data, dev)
        with spans.span("train_step"):
            params, opt, m = step(params, opt, spikes, labels)
        with spans.span("sync"):
            return float(m["loss"])

    n_check = mix["check_steps"]
    losses, first_grad = [], None
    for i in range(n_check):
        losses.append(one(i))
        if i == 0:
            first_grad = [(mu / 0.1).cpu().numpy() for mu in opt.mu]
    w_after = [p.w.detach().cpu().numpy() for p in params]
    print(f"perfbench: set-up: imports {t_enter - ctx.started:.2f} s, "
          f"weights and step (CUDA start included) {t_built - t_enter:.2f}"
          f" s, {n_check} checked steps {clock() - t_built:.2f} s",
          file=sys.stderr)
    trace = DeviceTrace(ctx.trace)
    ctx.window_opens()
    trace.start()
    t_open, i, n_steps, bad = clock(), n_check, 0, 0
    # a traced run traces a fixed number of steps: a step launches some
    # 10^5 kernels, and the whole window's trace would take minutes to read
    while (n_steps < mix["trace_steps"] if ctx.trace
           else clock() < t_open + ctx.seconds):
        loss = one(i)
        bad += not np.isfinite(loss)
        i += 1
        n_steps += 1
    t_close = clock()
    trace.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del params, opt, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    batches = [inputs.dvs_batch(ctx.seed, j, B, data, dev)
               for j in range(n_check)]
    ref = ecnn.train(layers, w0, batches, optimizer_settings(mix))
    program = {"losses": losses, "first_grad": first_grad,
               "w_after": w_after,
               "w0": [w.cpu().numpy() for w in w0]}
    checks = judge(program, ref, mix["limits"])
    return Outcome(
        end_to_end={"train_samples_per_s": B * n_steps / (t_close - t_open)},
        readings={"spans": spans.records, "trace": trace, "layers": layers,
                  "batch": B, "timesteps": cfg["n_timesteps"],
                  "steps": n_steps,
                  "window": (trace.t0, trace.t1)},
        checks=checks, attempted=n_steps, failed=bad,
        memory_peak_bytes=int(peak))
