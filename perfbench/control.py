#!/usr/bin/env python3
"""The controls of ``correct``: what the comparison reads when the plain
reference, computed one precision below the configuration's, stands in the
program's place, and what it reads under the faults a cell can have.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]

Serving cells: the reference with an int4 membrane state (clip 7) in place
of the configuration's 8-bit one (clip 127), its answers judged against
the 8-bit reference's on every recording of the seed's pool.  Training
cells: the reference with every convolution's and product's operands in
TF32, and the reference fed half of each batch (the mean over the rest),
each judged against the float32 reference on the first steps.  Prints one
JSON line per seed.  Runs on the card when there is one; the tests run it
at a small size on the CPU.
"""
import argparse
import json
import pathlib
import sys
from types import SimpleNamespace

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path[:0] = [str(REPO)]

from perfbench import core, inputs  # noqa: E402
from perfbench.reference import ecnn  # noqa: E402


def _answer(class_counts, per_layer_events):
    """A reference answer shaped as a served request's."""
    return SimpleNamespace(class_counts=class_counts,
                           telemetry=SimpleNamespace(
                               per_layer_events=list(per_layer_events)))


def serving_control(config: dict, mix: dict, seed: int, device,
                    state_bits: int = 4) -> dict:
    """The serving comparison with the reference at ``state_bits`` in the
    program's place, over every recording of the seed's pool."""
    from perfbench.drivers import closed_serve
    layers = inputs.layer_shapes(config)
    weights = inputs.make_weights(config, seed, device)
    pool = inputs.recording_pool(config, mix, seed)
    want = closed_serve.reference_answers(
        layers, weights, pool, config, device,
        state_bits=config["quantization"]["state_bits"])
    got = closed_serve.reference_answers(layers, weights, pool, config,
                                         device, state_bits=state_bits)
    done = [(i, _answer(got["class_counts"][i], got["events"][i].sum(-1)))
            for i in range(len(pool))]
    return closed_serve.compare(done, want)


def training_control(config: dict, mix: dict, seed: int, device,
                     fault: str = "tf32") -> dict:
    """The training comparison with the reference in the program's place:
    ``"tf32"`` computes it in TF32, ``"half_batch"`` feeds it half of each
    batch."""
    from perfbench.drivers import train_step
    layers = inputs.layer_shapes(config)
    w0 = inputs.make_weights(config, seed, device)
    opt = train_step.optimizer_settings(mix)
    batches = [inputs.dvs_batch(seed, j, mix["batch"], mix["data"], device)
               for j in range(mix["check_steps"])]
    want = ecnn.train(layers, w0, batches, opt)
    if fault == "half_batch":
        half = mix["batch"] // 2
        got = ecnn.train(layers, w0, [(s[:half], l[:half])
                                      for s, l in batches], opt)
    else:
        got = ecnn.train(layers, w0, batches, opt, tf32=True)
    program = {"losses": got["losses"],
               "first_grad": [g.cpu().numpy() for g in got["first_grad"]],
               "w_after": [w.cpu().numpy() for w in got["weights"]],
               "w0": [w.cpu().numpy() for w in w0]}
    return train_step.judge(program, want, mix["limits"])


def main(argv=None) -> int:
    """Print the controls' readings of a cell, one JSON line a seed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    cell = core.resolve(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        if cell.mix["kind"] == "train_step":
            rows = {f: training_control(cell.config, cell.mix, seed, dev, f)
                    for f in ("tf32", "half_batch")}
        else:
            rows = {"state_int4": serving_control(cell.config, cell.mix,
                                                  seed, dev)}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": str(dev), "readings": rows}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
