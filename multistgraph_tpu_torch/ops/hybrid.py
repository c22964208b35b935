"""Hub columns and the scattered COO tail beside a BSR remainder.

Counterpart of multistgraph_tpu/ops/hybrid.py. A high-fan-in column (a
hub every row points at) puts one nearly empty 128x128 tile in almost
every row block; extracted into a dense skinny matrix its product is

    y += A[:, hubs] @ x[hubs]             # (N_pad, H) @ (H, F)

a plain matmul. Edges scattered one per tile go to a COO tail:

    y[tail_src] += tail_w * x[tail_dst]   # gather, scale, index_add_

Both are plain torch ops, as they are XLA ops in JAX, and autograd closes
over them; the BSR remainder goes through ops/spmm.py's kernel. On the
card index_add_ (and the gather's backward, an index_add_) adds with
atomics in the order the threads arrive; given the tail's fixed orders
(``tail_order``, built once) the tail sums each row's edges, and the
gather's backward each column's, by segment sums, one thread a segment,
so repeated steps are bit-identical, as JAX's sorted segment_sum is. The
builders reproduce the JAX package's arrays bit for bit (numpy builder;
the native C++ builder of the JAX package is not ported, ROADMAP.md A.6).
"""

from dataclasses import dataclass

import numpy as np
import torch

from multistgraph_tpu_torch.ops.bsr import BSRGraph, bsr_from_coo
from multistgraph_tpu_torch.ops.spmm import BLOCK, spmm


@dataclass(frozen=True)
class HybridGraph:
    bsr: BSRGraph           # the low-fan-in remainder
    hub_cols: np.ndarray    # (H,) int32 column node ids
    hub_values: np.ndarray  # (padded_nodes, H) float32 = A[:, hub_cols]

    @property
    def num_hubs(self) -> int:
        return int(self.hub_cols.shape[0])

    @property
    def nnz_edges(self) -> int:
        return self.bsr.nnz_edges + int((self.hub_values != 0).sum())

    @property
    def padded_nodes(self) -> int:
        return self.bsr.padded_nodes

    @property
    def num_row_blocks(self) -> int:
        return self.bsr.num_row_blocks

    @property
    def block(self) -> int:
        return self.bsr.block


def split_hub_columns(src: np.ndarray, dst: np.ndarray, weights: np.ndarray, num_nodes: int,
                      block: int = 128, max_hubs: int = 64, min_row_blocks: int = None) -> HybridGraph:
    """Partition COO edges into (BSR remainder, dense hub columns): a column
    is extracted when more than `min_row_blocks` distinct row blocks touch
    it (default num_row_blocks // block, the byte break-even), capped at the
    `max_hubs` highest-fan-in columns. Duplicate edges accumulate."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weights, np.float32)
    n_blocks = -(-num_nodes // block)
    padded = n_blocks * block
    if min_row_blocks is None:
        min_row_blocks = max(1, n_blocks // block)

    # per column: how many distinct row blocks touch it
    pair = (src // block) * padded + dst
    uniq = np.unique(pair)
    touched = np.bincount(uniq % padded, minlength=num_nodes)[:num_nodes]
    hubs = np.flatnonzero(touched > min_row_blocks)
    if len(hubs) > max_hubs:
        hubs = hubs[np.argsort(-touched[hubs], kind="stable")[:max_hubs]]
        hubs = np.sort(hubs)

    if len(hubs) == 0:
        bsr = bsr_from_coo(src, dst, w, num_nodes, block)
        return HybridGraph(bsr=bsr, hub_cols=np.zeros((0,), np.int32),
                           hub_values=np.zeros((bsr.padded_nodes, 0), np.float32))

    pos = np.full(num_nodes, -1, np.int64)
    pos[hubs] = np.arange(len(hubs))
    is_hub = pos[dst] >= 0
    hub_values = np.zeros((padded, len(hubs)), np.float32)
    np.add.at(hub_values, (src[is_hub], pos[dst[is_hub]]), w[is_hub])
    rest = ~is_hub
    bsr = bsr_from_coo(src[rest], dst[rest], w[rest], num_nodes, block)
    return HybridGraph(bsr=bsr, hub_cols=hubs.astype(np.int32), hub_values=hub_values)


@dataclass(frozen=True)
class TailGraph:
    """BSR for well-filled tiles plus a COO tail for scattered edges."""

    bsr: BSRGraph
    tail_src: np.ndarray  # (E,) int32 row node ids, sorted ascending
    tail_dst: np.ndarray  # (E,) int32 column node ids
    tail_w: np.ndarray    # (E,) float32

    @property
    def num_tail_edges(self) -> int:
        return int(self.tail_w.shape[0])

    @property
    def nnz_edges(self) -> int:
        return self.bsr.nnz_edges + self.num_tail_edges

    @property
    def padded_nodes(self) -> int:
        return self.bsr.padded_nodes

    @property
    def num_row_blocks(self) -> int:
        return self.bsr.num_row_blocks

    @property
    def block(self) -> int:
        return self.bsr.block


def split_scattered_tail(src: np.ndarray, dst: np.ndarray, weights: np.ndarray, num_nodes: int,
                         block: int = 128, min_fill: int = None) -> TailGraph:
    """Partition COO edges into (BSR of tiles holding at least `min_fill`
    edges, default block // 2; COO tail of the rest, sorted by row)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weights, np.float32)
    n_blocks = -(-num_nodes // block)
    if min_fill is None:
        min_fill = block // 2

    tile = (src // block) * n_blocks + dst // block
    _, inverse, counts = np.unique(tile, return_inverse=True, return_counts=True)
    in_tail = counts[inverse] < min_fill

    order = np.argsort(src[in_tail], kind="stable")
    keep = ~in_tail
    bsr = bsr_from_coo(src[keep], dst[keep], w[keep], num_nodes, block)
    return TailGraph(bsr=bsr, tail_src=src[in_tail][order].astype(np.int32),
                     tail_dst=dst[in_tail][order].astype(np.int32), tail_w=w[in_tail][order])


def tail_order(tail_src: np.ndarray, tail_dst: np.ndarray, num_out: int):
    """The tail's fixed summation orders, from its static edges (sorted by
    row): (the rows' edge offsets, the edges in column order (stable), the
    columns' offsets in that order), int32 arrays (the graph's index
    dtype) for spmm_tail's `order`."""
    src = np.asarray(tail_src, np.int64)
    dst = np.asarray(tail_dst, np.int64)
    by_dst = np.argsort(dst, kind="stable")
    bounds = np.arange(num_out + 1)
    return tuple(a.astype(np.int32) for a in (np.searchsorted(src, bounds), by_dst,
                                              np.searchsorted(dst[by_dst], bounds)))


class _OrderedGather(torch.autograd.Function):
    """x[idx], whose backward sums each row of x's cotangent over its
    gathered edges in edge order (segment sums over the edges sorted by
    idx) instead of index_select's atomic index_add_."""

    @staticmethod
    def forward(ctx, x, idx, by_idx, idx_ptr):
        ctx.save_for_backward(by_idx, idx_ptr)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        by_idx, idx_ptr = ctx.saved_tensors
        return (torch.segment_reduce(grad.index_select(0, by_idx), "sum", offsets=idx_ptr.long(), axis=0,
                                     unsafe=True), None, None, None)


def spmm_tail(tail_w, tail_src, tail_dst, x, num_out: int, order=None):
    """Y[tail_src] += tail_w * X[tail_dst]: one gather, one scale and one
    index_add_ (JAX: take, scale, segment_sum), in x's dtype (JAX casts the
    sum to it, hybrid.py:228-231). On the CPU index_add_ sums in edge order,
    as segment_sum does; on the card its atomics add in an order that
    changes from run to run. With `order` (tail_order's arrays as tensors on
    x's device, num_out rows) each row's and, in the backward, each
    column's sum runs in edge order by segment sums, on any device (16-bit
    sums may round otherwise than index_add_'s, which rounds each add)."""
    if order is None:
        contrib = tail_w.to(x.dtype)[:, None] * x.index_select(0, tail_dst)
        return x.new_zeros(num_out, x.shape[1]).index_add_(0, tail_src, contrib)
    src_ptr, by_dst, dst_ptr = order
    contrib = tail_w.to(x.dtype)[:, None] * _OrderedGather.apply(x, tail_dst, by_dst, dst_ptr)
    return torch.segment_reduce(contrib, "sum", offsets=src_ptr.long(), axis=0, unsafe=True)


def spmm_hub(hub_values, hub_cols, x):
    """A[:, hubs] @ X[hubs]: the dense skinny hub columns' product, in x's
    dtype (the model stores its hub columns in its compute dtype, as JAX's
    attach_graph does, so the cast is free there)."""
    return hub_values.to(x.dtype) @ x.index_select(0, hub_cols)


def spmm_tail_hybrid(values, row_of, col_of, tail_w, tail_src, tail_dst, x, block: int = BLOCK):
    """Y = A X for a tail-split graph: the BSR SpMM on the dense-enough tiles
    plus the COO tail. Differentiable in values, tail_w and x."""
    y = spmm(values, row_of, col_of, x, block=block) if values.shape[0] > 0 else torch.zeros_like(x)
    if tail_w.shape[0] > 0:
        y = y + spmm_tail(tail_w, tail_src, tail_dst, x, x.shape[0])
    return y


def spmm_hybrid(values, row_of, col_of, hub_values, hub_cols, x, block: int = BLOCK):
    """Y = A X for a hub-split graph: the BSR SpMM on the remainder plus one
    skinny dense matmul for the hub columns. Differentiable in values,
    hub_values and x."""
    y = spmm(values, row_of, col_of, x, block=block) if values.shape[0] > 0 else torch.zeros_like(x)
    if hub_values.shape[1] > 0:
        y = y + spmm_hub(hub_values, hub_cols, x)
    return y
