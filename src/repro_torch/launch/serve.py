"""LM serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Host mode runs the slot-batched continuous-batching engine on the arch's
reduced (smoke) config with seeded random weights and synthetic prompts,
and prints one summary line.  ``--arch`` takes every arch the engine
serves: all but the encoder and frontend configs (whisper-medium,
internvl2-26b).  ``--device`` picks the device (default: the CUDA device;
``--device cpu`` runs the plain PyTorch path on the CPU).
``--production-lower`` runs the full config's ``--shape`` cell of the
dry-run instead (``launch.dryrun.run_cell`` on the single-pod production
mesh, meta tensors, no allocation) and saves its record under
``experiments/dryrun``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--production-lower", action="store_true")
    ap.add_argument("--shape", default="decode_32k",
                    choices=("decode_32k", "long_500k", "prefill_32k"))
    args = ap.parse_args(argv)

    if args.production_lower:
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell(args.arch, args.shape, multi_pod=False)
        dryrun.save_record(rec, "experiments/dryrun")
        return

    from repro_torch.configs import get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    rng = np.random.default_rng(args.seed)
    params = T.init_model(torch.Generator(dev).manual_seed(args.seed), cfg,
                          dev)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      cache_len=args.cache_len,
                      temperature=args.temperature, seed=args.seed,
                      device=dev)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len),
                    max_tokens=args.max_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    eng.run(reqs)
    dt = time.time() - t0
    gen = eng.stats["generated"]
    print(f"[serve] {args.requests} requests, {gen} tokens in {dt:.2f}s "
          f"({gen/max(dt,1e-9):.1f} tok/s, "
          f"{eng.stats['decode_steps']} batched steps, "
          f"mean occupancy {gen/max(eng.stats['decode_steps'],1):.2f}/"
          f"{args.slots}) on {dev}")
    if not all(r.done for r in reqs):
        raise RuntimeError("some requests did not finish")


if __name__ == "__main__":
    main()
