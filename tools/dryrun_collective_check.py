"""Hold the dry-run's modelled collectives against the JAX reference's own
count, on the CPU.

The port issues no collective on its dense path, so
``repro_torch.launch.dryrun.modelled_collectives`` models the ones the
reference's SPMD partitioner inserts.  This script compiles the
reference's step for granite-8b's smoke config on a 2 x 2 host mesh
(``build_step_fn`` and ``parse_collective_bytes`` of ``repro.launch.
dryrun``, four host devices) for train, prefill and decode, computes the
port's modelled rows for the same cell, and prints per kind the payload
and wire bytes per device of each and their ratio (model / HLO).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_collective_check.py

It imports both packages (as the tests do) and is not part of either.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402

B, S = 4, 64
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def main() -> int:
    assert len(jax.devices()) == 4, jax.devices()
    from jax.sharding import AxisType
    from repro.configs import ShapeSpec as RShape, get_smoke as r_smoke
    from repro.distributed import sharding as RS
    from repro.launch import dryrun as RD
    from repro_torch.configs import ShapeSpec, get_smoke
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch import dryrun as PD

    class Stub:
        shape = {"data": 2, "model": 2}

    out = {}
    for kind in ("train", "prefill", "decode"):
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        rules = RS.default_rules(False)
        cfg = r_smoke("granite-8b")
        RS.set_mesh_rules(mesh, rules)
        try:
            fn, args, _ = RD.build_step_fn(cfg, RShape("s", S, B, kind),
                                           mesh, rules)
            with mesh:
                hlo = fn.lower(*args).compile().as_text()
        finally:
            RS.clear_mesh_rules()
        ref = RD.parse_collective_bytes(hlo)
        rows = PD.modelled_collectives(
            get_smoke("granite-8b"), ShapeSpec("s", S, B, kind), Stub(),
            default_rules(False))
        mine = PD.summarize_collectives(rows)
        out[kind] = {}
        for k in KINDS:
            r, m = ref[k], mine[k]
            if not (r["count"] or m["count"]):
                continue
            out[kind][k] = {
                "hlo_count": r["count"], "model_count": m["count"],
                "hlo_bytes": r["bytes"], "model_bytes": m["bytes"],
                "hlo_wire": r["wire_bytes"], "model_wire": m["wire_bytes"],
                "wire_ratio": (m["wire_bytes"] / r["wire_bytes"]
                               if r["wire_bytes"] else None)}
        out[kind]["total_wire_ratio"] = (mine["total_wire_bytes"]
                                         / ref["total_wire_bytes"])
    json.dump(out, sys.stdout, indent=1)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
