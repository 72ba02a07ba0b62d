"""Shared inputs for the port's parity tests (``tests/test_torch_*.py``).

Every graph is built once from numpy arrays and handed to both sides: the
reference ``repro.graph.Graph`` and the port's ``repro_torch.graph.Graph``.
The three structural graphs are the ones ``tests/test_exec.py`` uses (same
builders, same seeds): a random graph, a skewed graph whose hub row
inflates the ELL width, and a graph whose later row blocks have no active
slot.

Under pytest-xdist each worker takes its share of the machine's cores for
torch's intra-op threads: every worker imports this module while it
collects, and without a share each would start an OpenMP pool as large as
the machine, the pools spinning against each other (a CPU autotune of Cora
that takes 5 s alone took two minutes beside two other test processes).
"""
import dataclasses
import os

import numpy as np
import torch

from repro.graph import Graph as RefGraph
from repro_torch.graph import Graph as PortGraph

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
        os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def random_graph(n=300, e=2000, seed=0) -> RefGraph:
    rng = np.random.default_rng(seed)
    return RefGraph(src=rng.integers(0, n, e).astype(np.int32),
                    dst=rng.integers(0, n, e).astype(np.int32), num_nodes=n)


def skewed_graph(n=1024, seed=1) -> RefGraph:
    rng = np.random.default_rng(seed)
    hub_dst = np.zeros(n, np.int32)
    hub_src = rng.permutation(n).astype(np.int32)
    tail = np.arange(n - 1, dtype=np.int32)
    return RefGraph(src=np.concatenate([hub_src, tail]),
                    dst=np.concatenate([hub_dst, tail + 1]), num_nodes=n)


def empty_row_graph(n=256) -> RefGraph:
    rng = np.random.default_rng(2)
    e = 400
    return RefGraph(src=rng.integers(0, n, e).astype(np.int32),
                    dst=rng.integers(0, 32, e).astype(np.int32), num_nodes=n)


GRAPHS = {
    "random": random_graph(),
    "skewed": skewed_graph(),
    "empty_rows": empty_row_graph(),
}


def to_port(g: RefGraph) -> PortGraph:
    """The same arrays as a port Graph."""
    return PortGraph(**{f.name: getattr(g, f.name)
                        for f in dataclasses.fields(PortGraph)})


def assert_bytes_equal(a, b, what=""):
    """Same dtype, same shape, same bytes (None matches None)."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"
