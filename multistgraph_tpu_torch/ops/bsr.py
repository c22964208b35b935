"""Block-sparse (BSR) graphs, built on the host with numpy.

Counterpart of the plain-BSR part of multistgraph_tpu/ops/bsr.py. Nodes are
padded to a multiple of ``block`` (128); every nonzero (row block, column
block) tile is stored densely:

    values  (nnz_blocks, block, block) float32
    row_of  (nnz_blocks,) int32   row-block index, sorted ascending
    col_of  (nnz_blocks,) int32   column-block index

in row-major block order. ``row_ptr_from_rows`` gives the CSR-of-blocks
offsets that the CUDA SpMM walks (multistgraph_tpu/ops/spmm_stream.py:63).

The builders draw the same random numbers in the same order and accumulate
duplicate edges with ``np.add.at`` in the same order as the JAX package's
numpy path, so a seed gives bit-identical graphs. ``random_spatial_graph``
also gives the split forms (ops/hybrid.py, ops/band.py). Node reorderings
(RCM, community) and the native builder are not ported yet (ROADMAP.md A.6).
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class BSRGraph:
    values: np.ndarray   # (nnz_blocks, block, block)
    row_of: np.ndarray   # (nnz_blocks,)
    col_of: np.ndarray   # (nnz_blocks,)
    num_nodes: int       # un-padded node count
    block: int

    @property
    def padded_nodes(self) -> int:
        return -(-self.num_nodes // self.block) * self.block

    @property
    def num_row_blocks(self) -> int:
        return self.padded_nodes // self.block

    @property
    def nnz_blocks(self) -> int:
        return int(self.values.shape[0])

    @property
    def nnz_edges(self) -> int:
        return int((self.values != 0).sum())

    def to_dense(self) -> np.ndarray:
        n = self.padded_nodes
        out = np.zeros((n, n), dtype=self.values.dtype)
        b = self.block
        for v, r, c in zip(self.values, self.row_of, self.col_of):
            out[r * b: (r + 1) * b, c * b: (c + 1) * b] = v
        return out[: self.num_nodes, : self.num_nodes]


def row_ptr_from_rows(row_of: np.ndarray, num_row_blocks: int) -> np.ndarray:
    """CSR offsets (num_row_blocks + 1,) int32 from a row-major-sorted row index array."""
    return np.searchsorted(np.asarray(row_of), np.arange(num_row_blocks + 1), side="left").astype(np.int32)


def bsr_from_coo(src: np.ndarray, dst: np.ndarray, weights: np.ndarray, num_nodes: int,
                 block: int = 128) -> BSRGraph:
    """BSR from COO edges; duplicate edges accumulate (np.add.at order)."""
    rb = src // block
    cb = dst // block
    n_blocks = -(-num_nodes // block)
    key = rb.astype(np.int64) * n_blocks + cb
    uniq, inverse = np.unique(key, return_inverse=True)
    values = np.zeros((len(uniq), block, block), dtype=np.float32)
    np.add.at(values, (inverse, src % block, dst % block), weights.astype(np.float32))
    return BSRGraph(values=values, row_of=(uniq // n_blocks).astype(np.int32),
                    col_of=(uniq % n_blocks).astype(np.int32), num_nodes=num_nodes, block=block)


def bsr_from_dense(adj: np.ndarray, block: int = 128) -> BSRGraph:
    """BSR from a dense adjacency, keeping only nonzero tiles."""
    n = adj.shape[0]
    pad = -(-n // block) * block
    padded = np.zeros((pad, pad), dtype=np.float32)
    padded[:n, :n] = adj
    nb = pad // block
    tiles = padded.reshape(nb, block, nb, block).transpose(0, 2, 1, 3)
    mask = np.abs(tiles).sum(axis=(2, 3)) > 0
    rows, cols = np.nonzero(mask)
    return BSRGraph(values=tiles[rows, cols].astype(np.float32), row_of=rows.astype(np.int32),
                    col_of=cols.astype(np.int32), num_nodes=n, block=block)


def random_spatial_graph(num_nodes: int, avg_degree: int = 16, locality: int = 256,
                         num_hubs: int = 8, hub_fraction: float = 0.05, seed: int = 0,
                         block: int = 128, split: str = None) -> Tuple[object, int]:
    """Spatially-local graph plus a few hub nodes (power-law-ish degree):
    most edges join nearby node ids (|dst - src| <= locality), a fraction
    lands on global hubs. Returns (graph, num_edges): a BSRGraph, or with
    ``split`` 'hub' | 'tail' | 'band' the HybridGraph, TailGraph or
    BandGraph of the same edges."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    n_local = int(num_edges * (1 - hub_fraction))
    src_local = rng.integers(0, num_nodes, n_local)
    offset = rng.integers(-locality, locality + 1, n_local)
    dst_local = np.clip(src_local + offset, 0, num_nodes - 1)
    n_hub = num_edges - n_local
    src_hub = rng.integers(0, num_nodes, n_hub)
    hubs = rng.integers(0, num_nodes, num_hubs)
    dst_hub = hubs[rng.integers(0, num_hubs, n_hub)]
    src = np.concatenate([src_local, src_hub])
    dst = np.concatenate([dst_local, dst_hub])
    w = rng.uniform(0.1, 1.0, num_edges).astype(np.float32)
    if split == "hub":
        from multistgraph_tpu_torch.ops.hybrid import split_hub_columns

        return split_hub_columns(src, dst, w, num_nodes, block), num_edges
    if split == "tail":
        from multistgraph_tpu_torch.ops.hybrid import split_scattered_tail

        return split_scattered_tail(src, dst, w, num_nodes, block), num_edges
    if split == "band":
        from multistgraph_tpu_torch.ops.band import split_band

        return split_band(src, dst, w, num_nodes, block), num_edges
    return bsr_from_coo(src, dst, w, num_nodes, block), num_edges


def random_powerlaw_graph(num_nodes: int, avg_degree: int = 16, seed: int = 0,
                          block: int = 128) -> Tuple[BSRGraph, int]:
    """Power-law-degree graph: Zipf-ranked destinations over a random node
    permutation. Returns (graph, num_edges)."""
    rng = np.random.default_rng(seed)
    num_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, num_edges)
    ranks = rng.zipf(1.5, num_edges).astype(np.int64) % num_nodes
    perm = rng.permutation(num_nodes)
    dst = perm[ranks]
    w = rng.uniform(0.1, 1.0, num_edges).astype(np.float32)
    return bsr_from_coo(src, dst, w, num_nodes, block), num_edges
