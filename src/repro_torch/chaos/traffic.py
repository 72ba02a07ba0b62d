"""Adversarial serve traffic: seeded bursts + malformed requests (the port
of ``repro/chaos/traffic.py``, numpy only; the same seed gives the same
requests).

:func:`repro_torch.serve.zipfian_trace` models healthy Poisson traffic; the chaos
drill needs the other kind — compressed arrival bursts that overload the
batcher (testing admission control and load shedding) and malformed node ids
(out-of-range / negative) that must be rejected, not crash the engine.
Everything is a pure function of the seed.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..serve.batcher import Request, zipfian_trace


def adversarial_trace(num_nodes: int, num_requests: int, *,
                      rate: float = 5000.0, overload: float = 10.0,
                      burst_fraction: float = 0.5,
                      malformed_fraction: float = 0.02,
                      a: float = 1.1, seed: int = 0) -> List[Request]:
    """A Zipfian trace with an overload burst and malformed ids spliced in.

    The middle ``burst_fraction`` of requests arrive at ``overload`` times
    the base ``rate`` (inter-arrival gaps divided by ``overload``), modeling
    a traffic spike; a seeded ``malformed_fraction`` of requests get node
    ids outside ``[0, num_nodes)`` (negative or past-the-end), modeling
    corrupt upstream traffic.  Request ids stay sequential and arrival times
    strictly increase, so the stream is a valid batcher input.
    """
    base = zipfian_trace(num_nodes, num_requests, a=a, rate=rate, seed=seed)
    rng = np.random.default_rng(seed + 0x5EED)
    gaps = np.diff([0.0] + [r.t_arrival for r in base])
    lo = int(num_requests * (0.5 - burst_fraction / 2))
    hi = int(num_requests * (0.5 + burst_fraction / 2))
    gaps[lo:hi] /= max(float(overload), 1.0)
    t = np.cumsum(gaps)
    n_bad = int(round(num_requests * malformed_fraction))
    bad_at = set(rng.choice(num_requests, size=n_bad, replace=False).tolist()
                 if n_bad else [])
    out: List[Request] = []
    for i, r in enumerate(base):
        node = r.node_id
        if i in bad_at:
            node = (-1 - int(rng.integers(0, 3)) if rng.integers(0, 2) == 0
                    else num_nodes + int(rng.integers(0, 7)))
        out.append(Request(req_id=i, node_id=node, t_arrival=float(t[i])))
    return out
