"""LM training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Host mode, as the reference's ``repro.launch.train``: a real training
run of the arch's config (``--smoke``: the reduced same-family config) on
one device with the synthetic sharded token pipeline
(``data/lm_ds.py``), ``warmup_cosine``, checkpoint / restore and
preemption handling (``train/loop.py``).  The stub inputs of the audio
and vision configs (``frames`` / ``patches``) are drawn once from a
``torch.Generator`` seeded ``--seed + 1`` and fed with every batch.
``--device`` picks the device (default: the CUDA device; ``--device cpu``
runs on the CPU).  ``--production-lower`` runs the arch's ``train_4k``
cell of the dry-run (``launch.dryrun.run_cell`` on the single-pod
production mesh, meta tensors, no allocation) and saves its record under
``experiments/dryrun``, as the reference's does.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    """Parse ``argv``, train, print one summary line; returns
    ``train_loop``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--production-lower", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.production_lower:
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell(args.arch, "train_4k", multi_pod=False)
        dryrun.save_record(rec, "experiments/dryrun")
        return rec

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.lm_ds import LmDatasetSpec, stream
    from repro_torch.device import resolve_device
    from repro_torch.models.frontend import frontend_feature_shape
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.loop import train_loop

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    ds = LmDatasetSpec(vocab_size=cfg.vocab_size, seq_len=args.seq)
    stub = {}
    fs = frontend_feature_shape(cfg, args.batch)
    if fs is not None:
        gen = torch.Generator(dev).manual_seed(args.seed + 1)
        stub["frames" if cfg.frontend == "audio" else "patches"] = \
            torch.randn(fs, generator=gen, device=dev).to(cfg.tdtype)

    def batches():
        for tokens, labels in stream(ds, args.seed, args.batch, device=dev):
            yield {"tokens": tokens, "labels": labels, **stub}

    out = train_loop(
        cfg, batches(), args.steps,
        warmup_cosine(args.lr, args.warmup, args.steps),
        seed=args.seed, ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every, loss_chunk=min(128, args.seq),
        device=dev)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
              f"({len(losses)} steps, {out['wall_time_s']:.1f}s, "
              f"{len(out['stragglers'])} straggler events) on {dev}")
    return out


if __name__ == "__main__":
    main()
