"""Checkpoints: save and restore parameter and optimizer trees, an async
writer, buddy-mirrored shards (the port of ``repro/train/checkpoint.py``).

Format, the reference's: one ``step_XXXXXXXX.npz`` per checkpoint step
holding the flattened leaves keyed ``params:<path>`` / ``opt:<path>`` (a
path joins dict keys and sequence indices with ``/``, dict keys in sorted
order, as ``jax.tree_util`` spells them), plus a small JSON manifest.  So
either package restores the other's files.  A bf16 leaf is stored as its
raw two bytes (numpy dtype ``|V2``), which is how the reference's numpy
writes one; the port reads such a leaf back bit-exactly into a bf16
template leaf (the reference, whose restore hands the array to
``jnp.asarray``, cannot read ``|V2`` leaves, its own included).  Restore
puts every leaf on its template leaf's device and dtype.

Durability contract: every publish is **torn-write-proof** — the payload is
written to a dot-prefixed temp file (invisible to ``available_steps``),
fsync'd, atomically renamed over the final name, and the directory entry is
fsync'd too, so a crash at any instant leaves either the old file or the
complete new one.

Redundancy (``save_mirrored_checkpoint``): each logical shard's slice of
the checkpoint is written twice — a primary copy in the shard's own
directory and a mirror in its *buddy* shard's directory
(``buddy_of(s) = (s + 1) % num_shards``); a restore needs one readable copy
per shard, so losing one shard's whole directory still restores
bit-identically.
"""
from __future__ import annotations

import json
import os
import queue
import re
import threading
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs

_STEP_RE = re.compile(r"^step_(\d{8})\.npz$")
_BF16_BYTES = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf; a bf16 tensor as its raw bytes (``|V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BYTES)
        return t.numpy()
    return np.asarray(leaf)


def _paths(tree, prefix: str = ""):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    sequences by index; ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in _paths(tree)}


def _host_copy(tree):
    """``tree`` with every leaf copied to a host numpy array (bf16 leaves as
    their raw bytes): what a checkpoint of it would hold."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return _to_numpy(tree)


def _fsync_dir(dirname: str) -> None:
    """Durably record a rename in the directory entry (best-effort on
    filesystems that refuse O_RDONLY directory fds)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_atomic(path: str, write_fn) -> None:
    """tmp-write + fsync + rename + dir-fsync.  The temp name is
    dot-prefixed so a crashed partial write can never be mistaken for a
    checkpoint by the ``step_*`` listing."""
    dirname = os.path.dirname(path) or "."
    tmp = os.path.join(dirname, "." + os.path.basename(path) + ".tmp")
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(dirname)


def _write_npz_atomic(path: str, blobs: Dict[str, np.ndarray]) -> None:
    _write_atomic(path, lambda f: np.savez(f, **blobs))


def _blobs(params, opt_state) -> Dict[str, np.ndarray]:
    blobs = {}
    for prefix, tree in (("params", params), ("opt", opt_state)):
        for k, v in _flatten_with_paths(tree).items():
            blobs[f"{prefix}:{k}"] = v
    return blobs


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    extra: Optional[Dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    blobs = _blobs(params, opt_state)
    _write_npz_atomic(path, blobs)
    manifest = {"step": step, "leaves": len(blobs), **(extra or {})}
    _write_atomic(os.path.join(ckpt_dir, f"step_{step:08d}.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    _gc_old(ckpt_dir, keep=3)
    return path


def available_steps(ckpt_dir: str) -> List[int]:
    """All checkpoint steps on disk, newest first (in-flight temp files and
    stray names never match the strict ``step_XXXXXXXX.npz`` pattern)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(f))]
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[0] if steps else None


def _read_blobs(path: str) -> Dict[str, np.ndarray]:
    """Eagerly load every member (CRC-checked), so corruption surfaces here
    as an exception instead of later as silent garbage."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _to_leaf(arr: np.ndarray, template):
    """A stored array on the template leaf's device and dtype."""
    if arr.dtype == _BF16_BYTES:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    return t


def _rebuild(data: Dict[str, np.ndarray], prefix: str, template):
    def build(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v, f"{path}/{k}" if path else str(k))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, f"{path}/{i}" if path else str(i))
                           for i, v in enumerate(t))
        return _to_leaf(data[f"{prefix}:{path}"], t)
    return build(template, "")


def _rebuild_trees(data, params_template, opt_template):
    return (_rebuild(data, "params", params_template),
            _rebuild(data, "opt", opt_template))


def _load_step(ckpt_dir, step, params_template, opt_template):
    data = _read_blobs(os.path.join(ckpt_dir, f"step_{step:08d}.npz"))
    p, o = _rebuild_trees(data, params_template, opt_template)
    return p, o, step


def restore_checkpoint(ckpt_dir: str, params_template, opt_template,
                       step: Optional[int] = None):
    """Restore into the structure of the templates: (params, opt_state,
    step), every leaf on its template leaf's device and dtype.

    With ``step=None``, a corrupt or torn newest ``.npz`` (bad zip header,
    garbled member, missing leaf) is *not* fatal: restore falls back to the
    next older checkpoint, counting ``train.ckpt_fallback`` per skip.  An
    explicit ``step`` means the caller wants exactly that checkpoint, so
    load errors propagate.
    """
    if step is not None:
        return _load_step(ckpt_dir, step, params_template, opt_template)
    steps = available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    last_err: Optional[Exception] = None
    for s in steps:
        try:
            return _load_step(ckpt_dir, s, params_template, opt_template)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            last_err = e
            obs.counter("train.ckpt_fallback").inc()
            obs.instant("train.ckpt_fallback", cat="train", step=s,
                        error=type(e).__name__)
    raise RuntimeError(
        f"all {len(steps)} checkpoints in {ckpt_dir} unreadable"
    ) from last_err


def _gc_old(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(f)))
    for s in steps[:-keep]:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step_{s:08d}{ext}"))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# buddy-mirrored sharded checkpoints (quorum restore)
# ---------------------------------------------------------------------------
def buddy_of(shard: int, num_shards: int) -> int:
    """The neighbour that keeps ``shard``'s mirror copy."""
    return (shard + 1) % num_shards


def _shard_dir(root: str, shard: int) -> str:
    return os.path.join(root, f"shard_{shard:02d}")


def _mirror_dir(root: str, shard: int, num_shards: int) -> str:
    """Where ``shard``'s mirror lives: inside its buddy's directory, so
    losing one shard's whole directory tree loses at most one copy of any
    slice."""
    return os.path.join(_shard_dir(root, buddy_of(shard, num_shards)),
                        f"mirror_{shard:02d}")


def _split_blobs(blobs: Dict[str, np.ndarray], num_shards: int
                 ) -> List[Dict[str, np.ndarray]]:
    """Deterministic round-robin of sorted leaf keys over shards."""
    out: List[Dict[str, np.ndarray]] = [{} for _ in range(num_shards)]
    for i, k in enumerate(sorted(blobs)):
        out[i % num_shards][k] = blobs[k]
    return out


def save_mirrored_checkpoint(root: str, step: int, params, opt_state,
                             num_shards: int,
                             extra: Optional[Dict] = None) -> str:
    """Write the checkpoint sharded over ``num_shards`` slices, each slice
    to its own shard directory AND its buddy's mirror directory (both
    torn-write-proof).  Keeps the newest 3 steps per directory."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    blobs = _blobs(params, opt_state)
    slices = _split_blobs(blobs, num_shards)
    fname = f"step_{step:08d}.npz"
    for s in range(num_shards):
        dirs = [_shard_dir(root, s)]
        if num_shards > 1:
            dirs.append(_mirror_dir(root, s, num_shards))
        for d in dirs:
            os.makedirs(d, exist_ok=True)
            _write_npz_atomic(os.path.join(d, fname), slices[s])
            _gc_old(d, keep=3)
    manifest = {"step": step, "num_shards": num_shards,
                "leaves": len(blobs), **(extra or {})}
    os.makedirs(root, exist_ok=True)
    _write_atomic(os.path.join(root, f"step_{step:08d}.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    obs.counter("train.ckpt_mirrored").inc()
    return root


def mirrored_available_steps(root: str, num_shards: int) -> List[int]:
    """Steps with at least one copy of any slice on disk, newest first."""
    steps: set = set()
    for s in range(num_shards):
        steps.update(available_steps(_shard_dir(root, s)))
        if num_shards > 1:
            steps.update(available_steps(_mirror_dir(root, s, num_shards)))
    return sorted(steps, reverse=True)


def _read_mirrored_step(root: str, step: int, num_shards: int
                        ) -> Dict[str, np.ndarray]:
    """Assemble one step from primaries, falling back per shard to the
    buddy mirror; raises if any shard has no readable copy (quorum lost)."""
    fname = f"step_{step:08d}.npz"
    merged: Dict[str, np.ndarray] = {}
    for s in range(num_shards):
        sources = [("primary", os.path.join(_shard_dir(root, s), fname))]
        if num_shards > 1:
            sources.append(
                ("mirror", os.path.join(_mirror_dir(root, s, num_shards),
                                        fname)))
        last_err: Optional[Exception] = None
        for src, path in sources:
            try:
                part = _read_blobs(path)
            except (OSError, ValueError, EOFError,
                    zipfile.BadZipFile) as e:
                last_err = e            # torn, garbled or missing copy
                continue
            if src == "mirror":
                obs.counter("train.ckpt_mirror_fallback").inc()
                obs.instant("train.ckpt_mirror_fallback", cat="train",
                            shard=s, step=step)
            merged.update(part)
            break
        else:
            raise RuntimeError(
                f"checkpoint quorum lost: shard {s} of step {step} has no "
                f"readable copy (primary or buddy mirror)") from last_err
    return merged


def restore_mirrored_checkpoint(root: str, params_template, opt_template,
                                num_shards: int, step: Optional[int] = None):
    """Quorum restore of a mirrored checkpoint (bit-identical to the saved
    trees as long as every slice survives in at least one copy).

    With ``step=None``, a step whose quorum is lost falls back to the next
    older step, counting ``train.ckpt_fallback`` — the same contract as
    :func:`restore_checkpoint`.
    """
    if step is not None:
        data = _read_mirrored_step(root, step, num_shards)
        p, o = _rebuild_trees(data, params_template, opt_template)
        return p, o, step
    steps = mirrored_available_steps(root, num_shards)
    if not steps:
        raise FileNotFoundError(f"no mirrored checkpoint in {root}")
    last_err: Optional[Exception] = None
    for s in steps:
        try:
            data = _read_mirrored_step(root, s, num_shards)
            p, o = _rebuild_trees(data, params_template, opt_template)
            return p, o, s
        except (RuntimeError, OSError, ValueError, KeyError,
                zipfile.BadZipFile) as e:
            last_err = e
            obs.counter("train.ckpt_fallback").inc()
            obs.instant("train.ckpt_fallback", cat="train", step=s,
                        error=type(e).__name__)
    raise RuntimeError(
        f"all {len(steps)} mirrored checkpoints in {root} unreadable"
    ) from last_err


class AsyncCheckpointer:
    """Background-thread writer: the train loop hands off host copies and
    keeps stepping (checkpoint I/O overlaps compute).

    ``save`` copies every leaf to the host on the caller's thread before it
    returns (as the reference's ``np.asarray`` does), so a step that then
    updates the parameters in place cannot change what is written.  A write
    error is raised by the next ``save`` or by ``wait``."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.last_error: Optional[Exception] = None

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, params, opt_state, extra = item
            try:
                save_checkpoint(self.ckpt_dir, step, params, opt_state, extra)
            except Exception as e:   # surfaced on the next save() / wait()
                self.last_error = e
            finally:
                self._q.task_done()

    def save(self, step: int, params, opt_state, extra=None):
        if self.last_error:
            raise self.last_error
        self._q.put((step, _host_copy(params), _host_copy(opt_state), extra))

    def wait(self):
        self._q.join()
        if self.last_error:
            raise self.last_error

    def close(self):
        self._q.join()
        self._q.put(None)
        self._worker.join(timeout=10)
