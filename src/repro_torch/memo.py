"""Values derived once from a host-side container and kept while it lives.

A ``BlockEll`` or ``SharedSetPlan`` is a frozen numpy container that an
aggregation reads on every call; its device tensors (and a block-ELL's
transpose) are built on the first call and reused.  Entries are keyed by
the container's identity and dropped when it is garbage collected.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable

_MEMO: Dict[int, Dict[Hashable, object]] = {}


def per_object(obj, key: Hashable, build: Callable[[], object]):
    """``build()``, computed once per ``(obj, key)`` while ``obj`` lives."""
    entry = _MEMO.get(id(obj))
    if entry is None:
        entry = _MEMO[id(obj)] = {}
        weakref.finalize(obj, _MEMO.pop, id(obj), None)
    if key not in entry:
        entry[key] = build()
    return entry[key]
