"""Counts of one eager step, traced without running it: the port's
counterpart of XLA's ``cost_analysis()`` and ``memory_analysis()`` and of
``hlo.collective_bytes`` on the compiled text.

:func:`count_step` runs the step under ``FakeTensorMode`` (tensors with
shapes and dtypes and no data; nothing is allocated) with a counting
``TorchDispatchMode`` on top, which sees every aten op the step dispatches,
its backward included:

* ``flops``: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, the SDPA and convolution ops); every other op counts 0, as the
  reference's roofline counts matrix work;
* ``bytes``: over every op that is not a view, the bytes of its tensor
  operands (read) and of its results (written); ``copy_`` / ``fill_`` /
  ``zero_`` do not read their destination.  Eager PyTorch does not fuse,
  so this is what the step moves; XLA's count of a fused program is lower;
* ``collectives``: the payload of each ``c10d`` op, the bytes of its result
  on this rank (of its input for a send), under the reference's five kinds
  (``hlo.COLLECTIVES``) plus ``broadcast``, with ``total`` and ``n_ops``:
  the dict of ``hlo.collective_bytes``.  ``broadcast`` is the port's own:
  its ZeRO layer gather (``dist.spmd.layer_of``) broadcasts from the
  layer's owner where GSPMD all-gathers;
* ``memory``: the reference's four keys in GB.  ``argument`` is the
  arguments' bytes, ``output`` the result's, ``alias`` the result's tensors
  that live in a donated argument's storage (updated in place), ``temp``
  the peak bytes of the storages the step creates that are live at once,
  less the outputs it creates; so ``peak = argument + max(output - alias,
  0) + temp`` is the arguments plus that peak.

The step must reach no hand-written kernel: a fake tensor has no data for a
kernel's host checks or its pointers.  The trace uses fake tensors on the
CPU (a fake ``cuda`` tensor would send a wrapper down its kernel branch),
and :func:`count_step` raises if any wrapper's ``launches`` moved.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from .hlo import COLLECTIVES

KINDS = COLLECTIVES + ("broadcast",)

# c10d op name -> the reference's collective kind
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_COLL_NAMESPACES = ("c10d", "_c10d_functional")

# ops that allocate without writing, or write without reading their first
# operand
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}
_WRITE_ONLY = {"copy_", "fill_", "zero_"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _launches() -> Dict[str, int]:
    """Every hand-written kernel wrapper's launch count."""
    from ..kernels import decode_attention, embedding_bag, sddmm
    from ..kernels import spmm_blockell as sb
    fns = (decode_attention.decode_attention, embedding_bag.embedding_bag,
           sddmm.sddmm, sb.spmm_blockell, sb.spmm_blockell_fused,
           sb.spmm_blockell_update, sb.spmm_blockell_compact,
           sb.spmm_blockell_update_compact)
    return {f.__name__: f.launches for f in fns}


class _Counter(TorchDispatchMode):
    """Counts flops, bytes and collective payloads of the ops it sees, and
    the bytes of the storages they create that are live at once."""

    def __init__(self, arg_storages: set):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.coll = {k: 0.0 for k in KINDS}
        self.n_coll = 0
        self.known = set(arg_storages)   # ids of argument / seen storages
        self.live = 0
        self.peak = 0

    def _created(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.known:
            return
        n = st.nbytes()
        self.known.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self.known.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(),
                    torch._C.DispatchKey.CompositeImplicitAutograd):
            # under no_grad / inference_mode a composite op (matmul, einsum)
            # reaches the mode whole: count the ops it decomposes into, as
            # autograd's dispatch would
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _COLL_NAMESPACES:
            kind = _C10D.get(name)
            if kind is not None:
                moved = _tensors(out) or _tensors((args, kwargs))
                self.coll[kind] += sum(_nbytes(t) for t in moved)
                self.n_coll += 1
            return out
        if ns != "aten":           # prim.device and the like move nothing
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in self.formulas:
            self.flops += int(self.formulas[packet](*args, **kwargs,
                                                    out_val=out))
        outs = _tensors(out)
        for t in outs:
            self._created(t)
        if func.is_view or name in _ALLOC:
            return out
        ins = _tensors((args, kwargs))
        if name in _WRITE_ONLY and ins:
            ins = ins[1:]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                          for t in outs)
        return out


def _to_fake(mode, x):
    """A fake tensor for ``x``: a ``meta`` tensor becomes a fake CPU tensor
    of its shape and dtype, any other tensor is converted by ``mode``
    (keeping which tensors share storage)."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.device.type == "meta":
        with mode:
            return torch.empty(x.shape, dtype=x.dtype, device="cpu")
    return mode.from_tensor(x)


def count_step(fn: Callable, args: Sequence[Any], *,
               donate: Sequence[int] = ()) -> Dict[str, Any]:
    """Trace ``fn(*args)`` once on fake tensors and count it (see the
    module's docstring).  ``args`` may hold real tensors (CPU), ``meta``
    tensors (their shapes and dtypes) and anything else, passed as is;
    ``donate`` names the arguments the step updates in place and returns
    (the reference's ``donate_argnums``).  Returns ``{"flops", "bytes",
    "collectives", "memory", "n_ops"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = _launches()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fargs = tree_map(lambda x: _to_fake(mode, x), tuple(args))
    in_tensors = _tensors(fargs)
    storages = {id(t.untyped_storage()): t for t in in_tensors}
    arg_bytes = sum(t.untyped_storage().nbytes()
                    for t in storages.values())
    donated = {id(t.untyped_storage()) for i in donate
               for t in _tensors(fargs[i])}
    counter = _Counter(set(storages))
    with mode, counter:
        out = fn(*fargs)
        outs = _tensors(out)
        out_bytes = sum(_nbytes(t) for t in outs)
        alias = sum(_nbytes(t) for t in outs
                    if id(t.untyped_storage()) in donated)
        created = sum(_nbytes(t) for t in outs
                      if id(t.untyped_storage()) not in storages)
        peak_live = counter.peak
    del out, outs
    after = _launches()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved:
        raise RuntimeError(f"a traced step launched hand-written kernels "
                           f"{moved}: count_step traces plain routes only")
    coll = dict(counter.coll)
    coll["total"] = float(sum(coll.values()))
    coll["n_ops"] = float(counter.n_coll)
    temp = max(peak_live - created, 0)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "collectives": coll, "n_ops": counter.n_ops,
            "memory": {
                "argument_gb_per_device": arg_bytes / 1e9,
                "output_gb_per_device": out_bytes / 1e9,
                "alias_gb_per_device": alias / 1e9,
                "temp_gb_per_device": temp / 1e9,
                "peak_gb_per_device": (arg_bytes + max(out_bytes - alias, 0)
                                       + temp) / 1e9}}
