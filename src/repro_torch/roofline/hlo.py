"""HLO parsing (the port's copy of ``repro/roofline/hlo.py``, framework-free
text functions): collective bytes + while-loop (scan) trip-count correction.

``compiled.cost_analysis()`` counts a while body ONCE (measured in probes),
and collective ops aren't in cost_analysis at all, so we:
  * parse collective ops (all-gather / all-reduce / reduce-scatter /
    all-to-all / collective-permute) with operand shapes from the HLO text;
  * detect while bodies, attribute ops inside them, and multiply by the trip
    count supplied by the caller (the model's layer count — known exactly
    from the arch config).
Shapes in the partitioned module are PER-DEVICE, which is what the roofline
needs.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
                "u64": 8, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def shape_bytes(shape_str: str) -> int:
    """'f32[16,128]{1,0}' -> bytes.  Tuple shapes handled by the caller."""
    m = re.match(r"(\w+)\[([\d,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    b = _DTYPE_BYTES.get(dt, 4)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * b


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes: int
    computation: str        # enclosing HLO computation name
    line: str


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    comp = "?"
    for line in hlo_text.splitlines():
        mc = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\([^)]*\))?\s*->.*{\s*$",
                      line)
        if mc and ("(" in line and "->" in line):
            comp = mc.group(1)
            continue
        for kind in COLLECTIVES:
            # match '<op> = <result> kind(' including TUPLE results (e.g.
            # all-to-all lowers to a tuple of per-peer slices); skip -done
            # halves of async pairs and get-tuple-element consumers
            idx = line.find(f" {kind}(")
            if idx < 0:
                idx = line.find(f" {kind}-start(")
            if idx < 0 or "=" not in line[:idx]:
                continue
            if f"{kind}-done" in line or "get-tuple-element" in line:
                continue
            result_part = line[:idx]
            shapes = re.findall(r"(\w+\[[\d,]*\])", result_part)
            payload = sum(shape_bytes(sh) for sh in shapes)
            if payload:
                ops.append(CollectiveOp(kind=kind, bytes=payload,
                                        computation=comp, line=line.strip()))
            break
    return ops


def while_body_names(hlo_text: str) -> List[str]:
    """Names of computations used as while-loop bodies."""
    return re.findall(r"while\([^)]*\),\s*condition=%?[\w.\-]+,\s*body=%?"
                      r"([\w.\-]+)", hlo_text)


def collective_bytes(hlo_text: str, loop_trip_counts: Optional[Dict[str, int]]
                     = None, default_trip: int = 1) -> Dict[str, float]:
    """Total collective payload bytes per kind, with while-body ops
    multiplied by their trip count.

    loop_trip_counts: mapping substring-of-body-name -> trips.  Bodies not
    matched use ``default_trip``.
    """
    ops = parse_collectives(hlo_text)
    bodies = set(while_body_names(hlo_text))

    def trips_for(comp: str) -> int:
        inside = any(b in comp or comp in b for b in bodies)
        if not inside:
            # fusions nested under body computations keep body-ish names
            inside = "while" in comp or "body" in comp
        if not inside:
            return 1
        if loop_trip_counts:
            for key, t in loop_trip_counts.items():
                if key in comp:
                    return t
        return default_trip

    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    out["total"] = 0.0
    for op in ops:
        t = trips_for(op.computation)
        out[op.kind] += op.bytes * t
        out["total"] += op.bytes * t
    out["n_ops"] = float(len(ops))
    return out
