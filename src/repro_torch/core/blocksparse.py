"""Block-sparse (block-ELL) adjacency construction (numpy copy of
``repro/core/blocksparse.py``).

The adjacency is tiled into (bm x bk) blocks; each destination block keeps
a fixed-width list of source-block ids (padded with -1) plus a weight tile
per slot, either as dense tiles or as a packed 0/1 bitmask for unweighted
graphs.  ``compact()`` flattens the padded (R, W) slot table into
row-major-sorted active-slot lists with CSR-style ``row_offsets`` — the
form the port's CUDA kernel walks, one destination block per CUDA block.
The tests hold every array here byte-equal to the reference's.

``row_lists`` builds, from the edges alone, what a walk over those tiles
finds in each destination row: its set entries in slot-then-k order, as
(source node, coefficient) lists behind CSR-style row pointers.  Where the
tiles are sparse the lists are a few thousandth of their bytes, and the
compact kernels walk them instead (``exec/plan.py`` chooses).

``attention_lists`` builds the lists GAT's attention walks
(``exec/gat.py``): every edge an entry, with no coefficient and one self
loop a node, and the transposed lists, each entry with its forward place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.structure import Graph


@dataclasses.dataclass(frozen=True)
class BlockCompaction:
    """Row-major-sorted active slots of a BlockEll (the compacted grid).

    rows / cols: (n_active,) int32 block coordinates, sorted by (row, col);
    blocks:      (n_active, bm, bk) weight tiles in the compute dtype;
    row_active:  (R,) bool — destination blocks with at least one active slot;
    row_offsets: (R + 1,) int64 CSR-style offsets into rows/cols per row block.
    """

    rows: np.ndarray
    cols: np.ndarray
    blocks: np.ndarray
    row_active: np.ndarray
    row_offsets: np.ndarray

    @property
    def n_active(self) -> int:
        return int(self.rows.shape[0])


@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Block-ELL sparse matrix A (dst-major: rows = destinations).

    block_cols: (R, W) int32 source-block index per slot, -1 = inactive.
    blocks:     (R, W, bm, bk) dense weight tiles (None when ``packed`` set).
    packed:     (R, W, bm, ceil(bk/8)) uint8 packed 0/1 mask (implicit unit
                weights; None for dense storage).
    """

    block_cols: np.ndarray
    blocks: Optional[np.ndarray]
    num_nodes: int
    bm: int
    bk: int
    packed: Optional[np.ndarray] = None

    @property
    def n_row_blocks(self) -> int:
        return int(self.block_cols.shape[0])

    @property
    def width(self) -> int:
        return int(self.block_cols.shape[1])

    @property
    def n_active(self) -> int:
        return int((self.block_cols >= 0).sum())

    @property
    def implicit(self) -> bool:
        """True when only the packed bitmask (unit weights) is stored."""
        return self.blocks is None

    @property
    def dtype(self) -> np.dtype:
        return (np.dtype(np.float32) if self.blocks is None
                else self.blocks.dtype)

    def dense_blocks(self, dtype=np.float32) -> np.ndarray:
        """(R, W, bm, bk) compute tiles of the padded grid, unpacking the
        bitmask if implicit."""
        if self.blocks is not None:
            return (self.blocks if self.blocks.dtype == dtype
                    else self.blocks.astype(dtype))
        R, W = self.block_cols.shape
        bits = np.unpackbits(self.packed, axis=-1, count=self.bk)
        return bits.reshape(R, W, self.bm, self.bk).astype(dtype)

    def storage_bytes(self) -> int:
        """Bytes the adjacency tiles occupy."""
        tiles = self.packed if self.blocks is None else self.blocks
        return int(tiles.nbytes + self.block_cols.nbytes)

    def compact(self, dtype=np.float32) -> BlockCompaction:
        """Row-major-sorted active-slot view for the compacted kernel; only
        the ``n_active`` live tiles are ever materialized."""
        R, W = self.block_cols.shape
        r_idx, s_idx = np.nonzero(self.block_cols >= 0)
        cols = self.block_cols[r_idx, s_idx]
        order = np.lexsort((cols, r_idx))       # sort by (row, col)
        r_idx, s_idx, cols = r_idx[order], s_idx[order], cols[order]
        if self.blocks is not None:
            tiles = self.blocks[r_idx, s_idx].astype(dtype, copy=False)
        else:
            # unpacked in place when the compute dtype is uint8: at
            # CITESEER-S scale the tiles alone are 8-11 GB
            tiles = np.unpackbits(self.packed[r_idx, s_idx], axis=-1,
                                  count=self.bk).astype(dtype, copy=False)
        row_active = np.zeros(R, bool)
        row_active[r_idx] = True
        row_offsets = np.zeros(R + 1, np.int64)
        np.add.at(row_offsets, r_idx + 1, 1)
        return BlockCompaction(rows=r_idx.astype(np.int32),
                               cols=cols.astype(np.int32),
                               blocks=tiles,
                               row_active=row_active,
                               row_offsets=np.cumsum(row_offsets))

    def _nnz(self) -> int:
        if self.blocks is not None:
            return int((self.blocks != 0).sum())
        active = self.block_cols >= 0
        return int(np.unpackbits(self.packed[active], axis=-1,
                                 count=self.bk).sum())

    def density_stats(self) -> dict:
        """Active-block count, fill fraction and mean in-tile density."""
        active = self.block_cols >= 0
        nnz = self._nnz()
        n_blocks_total = self.n_row_blocks * max(
            1, int(np.ceil(self.num_nodes / self.bk)))
        if self.blocks is not None:
            per_block_nnz = (self.blocks != 0).sum(axis=(2, 3))[active]
        else:
            per_block_nnz = np.unpackbits(
                self.packed[active], axis=-1, count=self.bk).sum(axis=(1, 2))
        return {
            "active_blocks": self.n_active,
            "total_blocks": n_blocks_total,
            "block_fill_fraction": self.n_active / max(n_blocks_total, 1),
            "mean_block_density": float(per_block_nnz.mean() / (self.bm * self.bk))
            if per_block_nnz.size else 0.0,
            "nnz": int(nnz),
            "feature_tile_loads": self.n_active,
            "storage_bytes": self.storage_bytes(),
            "implicit_weights": self.implicit,
        }


def build_blockell(g: Graph, bm: int = 128, bk: int = 128,
                   width: Optional[int] = None,
                   storage: str = "dense",
                   dtype: Optional[np.dtype] = None) -> BlockEll:
    """Tile the adjacency into block-ELL (``storage``: dense | bitmask |
    auto, where auto picks the bitmask whenever it is exact)."""
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    w = (g.edge_weight[valid] if g.edge_weight is not None
         else np.ones(src.shape[0], np.float32))
    if dtype is None:
        dtype = w.dtype if g.edge_weight is not None else np.float32
    return build_blockell_coo(src, dst, w, num_nodes=g.num_nodes, bm=bm,
                              bk=bk, width=width, storage=storage,
                              dtype=dtype)


def build_blockell_coo(src: np.ndarray, dst: np.ndarray, w: np.ndarray, *,
                       num_nodes: int, num_rows: Optional[int] = None,
                       bm: int = 128, bk: int = 128,
                       width: Optional[int] = None, storage: str = "dense",
                       dtype: Optional[np.dtype] = None) -> BlockEll:
    """:func:`build_blockell` over bare COO arrays, possibly rectangular
    (``num_rows`` destination rows against ``num_nodes`` sources)."""
    if storage not in ("dense", "bitmask", "auto"):
        raise ValueError(f"unknown storage {storage!r}")
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w)
    if dtype is None:
        dtype = np.float32
    n = num_nodes
    n_rows = num_rows if num_rows is not None else n
    R = max(int(np.ceil(n_rows / bm)), 1)
    C = int(np.ceil(n / bk))
    rb, cb = dst // bm, src // bk
    key = rb * C + cb
    uniq, inv = np.unique(key, return_inverse=True)
    urb, ucb = uniq // C, uniq % C
    counts = np.bincount(urb, minlength=R)
    W = width or max(int(counts.max(initial=1)), 1)
    if counts.max(initial=0) > W:
        raise ValueError(f"block-ELL width overflow: need {counts.max()} > {W}")

    # the bitmask is exact only for unit weights with no duplicate edges
    if storage in ("bitmask", "auto"):
        edge_key = dst * n + src
        unit = bool(np.all(w == 1.0)) and np.unique(edge_key).size == src.size
        if storage == "bitmask" and not unit:
            raise ValueError("bitmask storage requires unit weights and "
                             "no duplicate edges")
        use_mask = unit
    else:
        use_mask = False

    block_cols = np.full((R, W), -1, np.int32)
    slot_of = np.zeros(uniq.shape[0], np.int64)
    fill = np.zeros(R, np.int64)
    for i, (r, c) in enumerate(zip(urb, ucb)):
        s = fill[r]
        block_cols[r, s] = c
        slot_of[i] = s
        fill[r] += 1
    if use_mask:
        # set bits directly in packed form (MSB-first, matching unpackbits)
        packed = np.zeros((R, W, bm, (bk + 7) // 8), np.uint8)
        lane = src % bk
        np.bitwise_or.at(
            packed, (rb, slot_of[inv], dst % bm, lane // 8),
            (np.uint8(1) << (7 - lane % 8).astype(np.uint8)))
        return BlockEll(block_cols=block_cols, blocks=None, num_nodes=n,
                        bm=bm, bk=bk, packed=packed)
    blocks = np.zeros((R, W, bm, bk), dtype)
    np.add.at(blocks, (rb, slot_of[inv], dst % bm, src % bk), w.astype(dtype))
    return BlockEll(block_cols=block_cols, blocks=blocks, num_nodes=n,
                    bm=bm, bk=bk)


@dataclasses.dataclass(frozen=True)
class RowLists:
    """Per-destination-row entry lists of a (bm, bk) tiling of A.

    row_ptr:    (n_rows + 1,) int32; row v's entries are
                [row_ptr[v], row_ptr[v + 1]);
    src:        (nnz,) int32 source node of each entry, each row's in the
                order a walk over its tiles lists them: slot (source block)
                ascending, then k, so sources ascending;
    coef:       (nnz,) float32 tile entry of each, or None where the tiles
                are the exact 0/1 bitmask (every coefficient 1);
    n_active:   active (bm, bk) slots of the tiling.

    An entry is a tile entry that is not zero: duplicate edges summed in
    edge order (the order ``build_blockell_coo`` adds them), zero sums left
    out, as the tile walks skip them."""

    row_ptr: np.ndarray
    src: np.ndarray
    coef: Optional[np.ndarray]
    n_active: int

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    def nbytes(self) -> int:
        """Bytes a walk over the lists reads: 4 an entry, 8 with coef."""
        return self.nnz * (8 if self.coef is not None else 4)

    def tile_bytes(self, bm: int, bk: int) -> int:
        """Bytes a walk over the same plan's compacted tiles reads: uint8
        tiles for the bitmask, float32 otherwise."""
        return self.n_active * bm * bk * (4 if self.coef is not None else 1)


def row_lists(g: Graph, bm: int = 128, bk: int = 128) -> RowLists:
    """The entry lists of ``build_blockell(g, bm, bk, storage="auto")
    .compact()``'s tiles, built from the edges by sorts (no tile is made):
    the same entries, coefficients and order, byte for byte."""
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    n = g.num_nodes
    C = int(np.ceil(n / bk))
    n_active = np.unique((dst // bm) * C + src // bk).size
    key, inv = np.unique(dst * n + src, return_inverse=True)
    coef = None
    w = g.edge_weight[valid] if g.edge_weight is not None else None
    if key.size != src.size or (w is not None and not np.all(w == 1.0)):
        # float32 tiles: each entry the sum of its edges' weights, added as
        # build_blockell_coo adds them (in its tile dtype, edge order)
        dtype = w.dtype if w is not None else np.float32
        acc = np.zeros(key.size, dtype)
        np.add.at(acc, inv, (w if w is not None
                             else np.ones(src.size, dtype)).astype(dtype))
        coef = acc.astype(np.float32)
        key, coef = key[coef != 0], coef[coef != 0]
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=row_ptr[1:])
    return RowLists(row_ptr=row_ptr.astype(np.int32),
                    src=(key % n).astype(np.int32), coef=coef,
                    n_active=int(n_active))


@dataclasses.dataclass(frozen=True)
class AttentionLists:
    """Both directions of an edge-softmax attention over a graph, as
    per-row entry lists with no coefficients: each edge is an entry (a
    duplicate edge is two), with one self loop a node where asked.

    row_ptr, src:      row v lists its sources j, ascending;
    row_ptr_t, dst_t:  the transposed lists, row j lists the rows v that
                       list j, ascending;
    fwd_pos:           (nnz,) int32, the place among ``src``'s entries of
                       each entry of ``dst_t``: the same edge."""

    row_ptr: np.ndarray
    src: np.ndarray
    row_ptr_t: np.ndarray
    dst_t: np.ndarray
    fwd_pos: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])


def attention_lists(g: Graph, self_loops: bool = True) -> AttentionLists:
    """The :class:`AttentionLists` of ``g``'s valid edges (edges flow src
    -> dst; its weights are not read), with ``(v, v)`` added for every node
    where ``self_loops``."""
    n = g.num_nodes
    valid = g.edge_mask if g.edge_mask is not None else np.ones(g.num_edges, bool)
    src = g.src[valid].astype(np.int64)
    dst = g.dst[valid].astype(np.int64)
    if self_loops:
        loops = np.arange(n, dtype=np.int64)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    # stable sorts (torch's, threaded: a third of numpy's time at REDDIT's
    # 28 M entries): the forward order is (dst, src), and sorted again by
    # src, stably, it becomes the transposed order (src, dst)
    fwd = torch.sort(torch.from_numpy(dst * n + src), stable=True)[1].numpy()
    bwd = fwd[torch.sort(torch.from_numpy(src[fwd]), stable=True)[1].numpy()]
    place = np.empty(fwd.size, np.int64)
    place[fwd] = np.arange(fwd.size)

    def ptr(rows):
        out = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=out[1:])
        return out.astype(np.int32)

    return AttentionLists(row_ptr=ptr(dst), src=src[fwd].astype(np.int32),
                          row_ptr_t=ptr(src), dst_t=dst[bwd].astype(np.int32),
                          fwd_pos=place[bwd].astype(np.int32))


def transpose_graph(g: Graph) -> Graph:
    """Reversed-edge view of ``g`` (A -> A^T): the backward-pass adjacency."""
    return dataclasses.replace(g, src=g.dst, dst=g.src)


def transpose_blockell(ell: BlockEll) -> BlockEll:
    """Aᵀ of a square (num_nodes x num_nodes) block-ELL, in its storage:
    tile (r, c) moves to (c, r), transposed; each new row block lists its
    slots by ascending source block.  The same matrix as
    ``build_blockell(transpose_graph(g))``, not always in the same slots."""
    R = ell.n_row_blocks
    C = max(-(-ell.num_nodes // ell.bk), 1)
    if R != max(-(-ell.num_nodes // ell.bm), 1):
        raise ValueError(f"{R} row blocks of {ell.bm} for {ell.num_nodes} "
                         "sources: only a square block-ELL transposes here")
    r_idx, s_idx = np.nonzero(ell.block_cols >= 0)
    c_idx = ell.block_cols[r_idx, s_idx].astype(np.int64)
    order = np.lexsort((r_idx, c_idx))          # by (new row, new col)
    r_idx, s_idx, c_idx = r_idx[order], s_idx[order], c_idx[order]
    counts = np.bincount(c_idx, minlength=C)
    W = max(int(counts.max(initial=1)), 1)
    slot = np.arange(c_idx.shape[0]) - (np.cumsum(counts) - counts)[c_idx]
    block_cols = np.full((C, W), -1, np.int32)
    block_cols[c_idx, slot] = r_idx
    if ell.implicit:
        bits = np.unpackbits(ell.packed[r_idx, s_idx], axis=-1, count=ell.bk)
        packed = np.zeros((C, W, ell.bk, (ell.bm + 7) // 8), np.uint8)
        packed[c_idx, slot] = np.packbits(bits.transpose(0, 2, 1), axis=-1)
        return BlockEll(block_cols=block_cols, blocks=None,
                        num_nodes=ell.num_nodes, bm=ell.bk, bk=ell.bm,
                        packed=packed)
    blocks = np.zeros((C, W, ell.bk, ell.bm), ell.blocks.dtype)
    blocks[c_idx, slot] = ell.blocks[r_idx, s_idx].transpose(0, 2, 1)
    return BlockEll(block_cols=block_cols, blocks=blocks,
                    num_nodes=ell.num_nodes, bm=ell.bk, bk=ell.bm)


def traffic_model(ell: BlockEll, d: int, bytes_per_el: int = 4) -> dict:
    """Device-memory traffic of one block-ELL SpMM vs a pure edge gather.

    gather baseline: every edge loads a d-vector (no reuse) = nnz * d * B.
    block-ELL:       one (bk, d) tile per active block + output writes +
                     the adjacency tiles at their storage width.
    """
    stats = ell.density_stats()
    gather = stats["nnz"] * d * bytes_per_el
    adj_bytes = (ell.n_active * ell.bm * ((ell.bk + 7) // 8) if ell.implicit
                 else ell.n_active * ell.bm * ell.bk * ell.dtype.itemsize)
    blocked = (stats["active_blocks"] * ell.bk * d * bytes_per_el
               + ell.n_row_blocks * ell.bm * d * bytes_per_el
               + adj_bytes)
    return {
        "gather_bytes": int(gather),
        "blockell_bytes": int(blocked),
        "adjacency_bytes": int(adj_bytes),
        "traffic_reduction": 1.0 - blocked / max(gather, 1),
        **stats,
    }


def choose_block_shape(d: int, vmem_budget: int = 8 * 2 ** 20,
                       bytes_per_el: int = 4) -> Tuple[int, int]:
    """Static node-level mapping heuristic (paper §IV-D2): the (bm, bk)
    tile, from 128 x 128 doubling each side up to 1024, whose working set
    (the adjacency tile, its x rows and its output rows) fits the budget.
    The default budget is the reference's (a TPU core's scoped VMEM); on the
    card pass ``roofline.hw.SMEM_BYTES_PER_BLOCK``, the shared memory one
    block may hold: at d = 16 that gives (256, 128), the bucketed plans'
    hub tile.  ``exec.autotune`` replaces this with measurement; this
    remains the zero-measurement prior."""
    bm = bk = 128

    def footprint(bm, bk):
        return (bm * bk + bk * d + bm * d) * bytes_per_el
    while footprint(bm * 2, bk) <= vmem_budget:
        bm *= 2
        if bm >= 1024:
            break
    while footprint(bm, bk * 2) <= vmem_budget:
        bk *= 2
        if bk >= 1024:
            break
    return bm, bk
