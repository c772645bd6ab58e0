"""Serve a small LM with batched requests (continuous batching).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        [--arch granite-8b] [--requests 12] [--slots 4] [--device cpu]

Uses the reduced same-family config of any decoder-only arch (the full
configs are exercised by the dry-run and by ``chip_smoke.py``), admits a
stream of synthetic prompts into the slot-batched `serve.engine.
ServeEngine` and reports throughput and occupancy.  The SNE angle:
decode work scales with the active slots, the serving-level face of
energy-proportional execution.  Weights are drawn from a
``torch.Generator`` on the device seeded ``--seed``; the prompts from
``numpy.random.default_rng(--seed)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print the summary; returns the engine's
    statistics, the wall time and each request's tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=96)
    ap.add_argument("--max-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    if cfg.encoder is not None or cfg.frontend is not None:
        raise SystemExit("enc-dec and frontend serving need audio or image "
                         "features; use a decoder-only arch for this example")
    dev = resolve_device(args.device)
    print(f"=== serving {cfg.name} ({T.param_count(cfg):,} params, "
          f"{args.slots} slots, cache {args.cache_len}) on {dev} ===")
    params = T.init_model(torch.Generator(dev).manual_seed(args.seed), cfg,
                          dev)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      cache_len=args.cache_len,
                      temperature=args.temperature, seed=args.seed,
                      device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(2, cfg.vocab_size,
                                        size=int(rng.integers(4, 17))),
                    max_tokens=args.max_tokens)
            for i in range(args.requests)]

    t0 = time.time()
    eng.run(reqs)
    dt = time.time() - t0
    if not all(r.done for r in reqs):
        raise RuntimeError("some requests did not finish")
    gen = eng.stats["generated"]
    occ = gen / max(eng.stats["decode_steps"], 1)
    print(f"done: {gen} tokens for {args.requests} requests in {dt:.2f}s")
    print(f"  {gen / dt:.1f} tok/s | {eng.stats['decode_steps']} batched "
          f"decode steps | mean occupancy {occ:.2f}/{args.slots} slots")
    print(f"  prefill tokens: {eng.stats['prefill_tokens']}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> "
              f"{r.out_tokens[:8]}{'...' if len(r.out_tokens) > 8 else ''}")
    return {"stats": dict(eng.stats), "wall_s": dt,
            "tokens": [list(r.out_tokens) for r in reqs],
            "done": [r.done for r in reqs]}


if __name__ == "__main__":
    main()
