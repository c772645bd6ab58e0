"""Per-op collective attribution for a dry-run cell (counterpart of
``repro.launch.hlo_analysis``).

The reference reads the partitioned HLO: each collective instruction with
its trip-count multiplier (nested while loops) and its ``op_name``
metadata, ranked by wire bytes.  The port has no HLO.  What it reads
instead are the rows the dry-run counted (``launch.dryrun``): one for
each collective that ``distributed.collectives`` issued, named by its
calling function, and the modelled rows of the collectives the
reference's partitioner would insert, named by their weight.  Rows of one
kind, payload, group, source and ``op_name`` merge into one line whose
``trips`` is their summed count.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union


def top_collectives(records: Union[Dict[str, Any], List[Dict[str, Any]]],
                    k: int = 25) -> List[Dict[str, Any]]:
    """The ``k`` largest collectives by total wire bytes.  ``records`` is a
    dry-run record (its ``collectives["rows"]``) or a list of rows."""
    rows = (records["collectives"]["rows"] if isinstance(records, dict)
            else records)
    merged: Dict[tuple, Dict[str, Any]] = {}
    for r in rows:
        key = (r["kind"], r["bytes"], r.get("group"), r.get("source"),
               r["op_name"])
        m = merged.setdefault(key, {
            "kind": r["kind"], "bytes": r["bytes"], "trips": 0,
            "wire_total": 0.0, "op_name": r["op_name"][:120],
            "source": r.get("source", "?")})
        m["trips"] += r["count"]
        m["wire_total"] += r["count"] * r["wire_bytes"]
    out = sorted(merged.values(), key=lambda r: -r["wire_total"])
    return out[:k]


def summarize(rows: List[Dict[str, Any]]) -> str:
    """A fixed-width table of :func:`top_collectives`' rows."""
    lines = [f"{'wire_GB':>9} {'kind':>18} {'trips':>6} {'payload_MB':>11}"
             f" {'source':>6}  op_name"]
    for r in rows:
        lines.append(
            f"{r['wire_total'] / 1e9:9.2f} {r['kind']:>18} "
            f"{r['trips']:6.0f} {r['bytes'] / 1e6:11.1f} "
            f"{r['source']:>6}  {r['op_name']}")
    return "\n".join(lines)
