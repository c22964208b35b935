"""SparseATGCN as a PyTorch nn.Module: the MultiATGCN recurrence at 50k-1M nodes.

Counterpart of the single-chip path of
multistgraph_tpu/models/sparse_atgcn.py. Graph convolution inside GRU
gates, over block-sparse supports:
  * the static support is a BSR graph (ops/bsr.py), aggregated by the SpMM
    kernel (ops/spmm.py: bsr_spmm, csrc/bsr_spmm.cu), or one of the split
    forms of ``graph_split``: BSR plus dense hub columns (HybridGraph) or a
    COO tail (TailGraph), ops/hybrid.py; or band diagonals (BandGraph,
    ops/band.py: the band kernels of csrc/band_spmm.cu) with the rest of the
    edges as hub columns and a COO tail, the band stored as per-offset
    planes or, with ``graph_band_packed``, as packed rows;
  * the adaptive view is relu(E1 E2) sampled at the graph's block pattern
    (the SDDMM kernel, csrc/sampled_matmul.cu) and row-normalised by a
    sparse softmax ('sampled' or 'dense_corrected'), then aggregated by
    the same SpMM;
  * the weight pools are shared (``node_conditioned='off'``) or factored
    through a node embedding ('factored');
  * the recurrence is a Python loop over T per layer; the input part of
    every step is aggregated once per layer (hoisted), and ``remat=True``
    checkpoints each step (torch.utils.checkpoint), as jax.checkpoint does.

On CUDA the executor and the service record its training step and its
forward as CUDA graphs (``graph_safe``; executor/graphs.py), the
counterpart of JAX's jitted programs. Nothing in forward or in the
autograd Functions of ops/spmm.py, ops/band.py and ops/hybrid.py reads
the device back or makes a shape from data: the segment schedules of the
static patterns and of their block transposes are built at construction
(their one host sync is there), the per-forward transposes, softmaxes and
SpMM workspaces are device ops of static shapes, and every kernel operand
(whose TMA view the launch encodes on the host) lies in the model's
buffers or parameters, in the step's static inputs or in the graph's
memory pool. The checkpointed steps keep torch.utils.checkpoint's default
``preserve_rng_state=True``: the model draws no random numbers, and the
stash and restore of the CUDA generator's state capture (an H100 with
torch 2.11 replays a captured checkpoint bit for bit either way).

Graph arrays are buffers registered with ``persistent=False``: the JAX
executor re-derives its zero-initialised 'graph' collection from the
dataset at init and keeps that form on load, so the port rebuilds them
from the dataset too and the tiles (324 MB per support at 49,152 nodes)
stay out of every checkpoint; so a model trained on band planes serves in
the packed form with no checkpoint migration. Parameters keep the JAX
package's flat names and shapes (``node_vec1``, ``l0_gate_pool``,
``end_kernel``, ...), the same for every graph form.

``compute_dtype='bfloat16'`` is JAX's mixed precision (sparse_atgcn.py:
111-118): the floating graph arrays are stored in bf16 at build time, the
activations, weight pools, node embeddings and head are cast to bf16 at
use, the cotangents are rounded to bf16 at the per-step input stack and
the layer-output stack (ops/precision.py), and the predictions come back
in f32; parameters and optimizer state stay f32. It runs on every
single-device form (BSR, hub, tail, band on planes or packed rows) with or
without the adaptive view: the BSR kernels take bf16 operands on the
tensor cores and return f32 sums (B4/B6) or bf16 scores (B5), and each
aggregation's f32 parts are summed before one cast to the compute dtype,
where JAX casts them. ``compute_dtype='float16'`` is the same with f16 in
place of bf16 (JAX passes any compute dtype through): the BSR kernels take
f16 operands on the tensor cores and return f32 sums (B4/B6) and f32 scores
(B5, as JAX's kernel emits f32 for f16), so the adaptive softmax runs in
f32 and its values are cast to f16; the band kernels take f16 planes or
packed rows and x and return f16. f16 overflows past 65504 where JAX's
does; no loss is scaled, as JAX scales none. The multi-chip backend raises
naming ROADMAP.md A.7.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multistgraph_tpu_torch.models.initializers import torch_style_init
from multistgraph_tpu_torch.ops.band import BandGraph, band_radius, pack_band_rows, spmm_band, spmm_band_packed
from multistgraph_tpu_torch.ops.bsr import BSRGraph, row_ptr_from_rows
from multistgraph_tpu_torch.ops.hybrid import (HybridGraph, TailGraph, spmm_hub, spmm_tail, split_hub_columns,
                                               tail_order)
from multistgraph_tpu_torch.ops.precision import round_cotangent
from multistgraph_tpu_torch.ops.spmm import (
    BsrSchedule,
    bsr_schedule,
    bsr_transpose,
    bsr_transpose_schedule,
    sddmm_relu,
    sparse_row_softmax,
    sparse_row_softmax_dense_corrected,
    spmm_pret,
)
from multistgraph_tpu_torch.utils import resolve_device


class SparseATGCN(nn.Module):
    """Input x: (B, T, N_pad, F) -> (B, Tout, N_pad, output_dim).

    ``supports``: the static supports, each a mapping of numpy arrays as
    JAX's support mapping (sparse_atgcn.py:52-67): a BSR part ``values``,
    ``row``, ``col``; hub columns ``hub_values``, ``hub_cols``; a COO tail
    ``tail_w``, ``tail_src``, ``tail_dst``; a band as ``band_values`` with
    ``band_offsets_static`` or ``band_packed`` with ``band_radius_static``.
    Keys ending in ``_static`` hold host metadata, not arrays.
    ``adaptive_pattern``: (row_of, col_of) numpy block pattern of the
    adaptive view, or None. ``compute_dtype``: None (f32), torch.bfloat16
    or torch.float16; the floating graph arrays are stored in it.
    """

    # read by the executor and the service: they record its steps as CUDA
    # graphs on the card (module docstring)
    graph_safe = True
    # read by utils/jax_import.py: the parameters carry the JAX names
    jax_names = True

    def __init__(self, num_nodes: int, output_window: int, output_dim: int, hidden_dim: int,
                 num_layers: int, embed_dim_adj: int, supports=(), adaptive_pattern=None,
                 node_conditioned: str = "off", embed_dim_node: int = 8, block: int = 128,
                 remat: bool = False, adaptive_softmax: str = "sampled", device=None,
                 compute_dtype=None):
        super().__init__()
        if node_conditioned not in ("off", "factored"):
            raise ValueError("node_conditioned must be 'off' or 'factored', got {!r}".format(node_conditioned))
        if adaptive_softmax not in ("sampled", "dense_corrected"):
            raise ValueError("unknown adaptive_softmax {!r}".format(adaptive_softmax))
        self.num_nodes = num_nodes
        self.output_window = output_window
        self.output_dim = output_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.embed_dim_adj = embed_dim_adj
        self.node_conditioned = node_conditioned
        self.embed_dim_node = embed_dim_node
        self.block = block
        self.remat = remat
        self.adaptive_softmax = adaptive_softmax
        self.compute_dtype = compute_dtype
        self.num_static = len(supports)
        self.has_adaptive = adaptive_pattern is not None
        nb = num_nodes // block

        def buffer(name, arr):
            t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
            if compute_dtype is not None and t.is_floating_point():
                t = t.to(compute_dtype)  # stored narrow, as JAX's attach_graph casts (sparse_atgcn.py:216-222)
            self.register_buffer(name, t, persistent=False)

        # bsr_spmm's segment schedules of each static BSR pattern and of its
        # block transpose (the backward's dX), built once with their
        # workspace slots counted exactly (none where no row is split)
        self._ws_slots = {}

        def schedules(prefix, row_ptr, row, col):
            ptr_t, sched_t = bsr_transpose_schedule(row, col, nb, exact=True)
            self.register_buffer(prefix + "row_ptr_t", ptr_t, persistent=False)
            for name, sched in (("schedule", bsr_schedule(row_ptr, row.shape[0], exact=True)),
                                ("schedule_t", sched_t)):
                self.register_buffer(prefix + name, sched.segments, persistent=False)
                self._ws_slots[prefix + name] = sched.ws_slots

        self._support_parts, self._support_static = [], []
        for i, support in enumerate(supports):
            parts = {k: v for k, v in support.items() if not k.endswith("_static")}
            if "values" in parts:
                parts["row_ptr"] = row_ptr_from_rows(parts["row"], nb)
            if "tail_src" in parts:   # the tail's fixed summation orders (ops/hybrid.py)
                parts.update(zip(("tail_ptr_src", "tail_by_dst", "tail_ptr_dst"),
                                 tail_order(parts["tail_src"], parts["tail_dst"], num_nodes)))
            for part, arr in parts.items():
                buffer("support{}_{}".format(i, part), arr)
            self._support_parts.append(tuple(parts))
            self._support_static.append({k: v for k, v in support.items() if k.endswith("_static")})
            if "values" in parts:
                schedules("support{}_".format(i), *(getattr(self, "support{}_{}".format(i, part))
                                                   for part in ("row_ptr", "row", "col")))
        if self.has_adaptive:
            row, col = adaptive_pattern
            buffer("adaptive_row", np.asarray(row, np.int32))
            buffer("adaptive_col", np.asarray(col, np.int32))
            buffer("adaptive_row_ptr", row_ptr_from_rows(row, nb))
            schedules("adaptive_", self.adaptive_row_ptr, self.adaptive_row, self.adaptive_col)

        def param(name, shape):
            self.register_parameter(name, nn.Parameter(torch.empty(shape, device=device)))

        n, h, ks = num_nodes, hidden_dim, self.num_supports
        if self.has_adaptive:
            param("node_vec1", (n, embed_dim_adj))
            param("node_vec2", (embed_dim_adj, n))
        if node_conditioned == "factored":
            param("node_emb", (n, embed_dim_node))
        for layer in range(num_layers):
            dim_in = 1 if layer == 0 else h  # the target channel only, at scale
            for cell, dim_out in (("gate", 2 * h), ("update", h)):
                if node_conditioned == "factored":
                    param("l{}_{}_pool".format(layer, cell), (embed_dim_node, ks, dim_in + h, dim_out))
                    param("l{}_{}_bias".format(layer, cell), (embed_dim_node, dim_out))
                else:
                    param("l{}_{}_pool".format(layer, cell), (ks, dim_in + h, dim_out))
                    param("l{}_{}_bias".format(layer, cell), (1, dim_out))
        param("end_kernel", (h, output_window * output_dim))
        param("end_bias", (1, output_window * output_dim))

    @property
    def num_supports(self) -> int:
        return 1 + self.num_static + (1 if self.has_adaptive else 0)

    # target-channel bounds, read by the loss and the executor
    @property
    def start_dim(self) -> int:
        return 0

    @property
    def end_dim(self) -> int:
        return self.output_dim

    def init_parameters(self, generator: torch.Generator):
        """xavier_uniform with torch's fan rules (U[0,1) for vectors), as the
        JAX package's torch_style_init and dense_kernel_init draw them; the
        draws come from a CPU generator, in parameter order."""
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch_style_init(tuple(p.shape), generator))

    # -------------------------------------------------------------- supports
    def _support(self, i):
        """Static support i's device arrays by part name."""
        return {part: getattr(self, "support{}_{}".format(i, part)) for part in self._support_parts[i]}

    @staticmethod
    def _has_bsr(sv):
        return "values" in sv and sv["values"].shape[0] > 0

    def _schedule(self, name):
        """The segment schedule `name` of a static BSR pattern."""
        return BsrSchedule(getattr(self, name), self._ws_slots[name])

    def _adaptive_values(self):
        """The adaptive view's normalised tiles and the dense-corrected
        softmax's background (None for 'sampled')."""
        row, col, row_ptr = self.adaptive_row, self.adaptive_col, self.adaptive_row_ptr
        # embeddings in the compute dtype; the scores come in sampled_matmul's
        # dtype (bf16 for bf16, else f32), and both softmaxes' values and
        # background are cast to the compute dtype (JAX sparse_atgcn.py:247,277,279)
        scores = sddmm_relu(self._cast(self.node_vec1), self._cast(self.node_vec2), row, col, block=self.block,
                            row_ptr=row_ptr, schedule=self._schedule("adaptive_schedule"),
                            transpose=(self.adaptive_row_ptr_t, self._schedule("adaptive_schedule_t")))
        nb = self.num_nodes // self.block
        if self.adaptive_softmax == "dense_corrected":
            vals, background = sparse_row_softmax_dense_corrected(scores, row, nb, self.num_nodes, row_ptr)
            return self._cast(vals), self._cast(background)
        return self._cast(sparse_row_softmax(scores, row, nb, row_ptr)), None

    def _precompute_transposes(self, adaptive):
        """Block transposes of every loop-invariant operand, once per forward
        (detached: the outputs do not depend on them), with the transposed
        patterns' row offsets and segment schedules built at construction,
        so that no step's backward transposes a support again or builds
        anything. Without autograd there is no backward and nothing to
        transpose."""
        if not torch.is_grad_enabled():
            return [None] * self.num_static, None
        nb = self.num_nodes // self.block

        def plan(values, row, col, prefix):
            return (*bsr_transpose(values, row, col, nb), getattr(self, prefix + "row_ptr_t"),
                    self._schedule(prefix + "schedule_t"))

        support_prets = []
        for i in range(self.num_static):
            sv = self._support(i)
            support_prets.append(plan(sv["values"], sv["row"], sv["col"], "support{}_".format(i))
                                 if self._has_bsr(sv) else None)
        adaptive_pret = None
        if adaptive is not None:
            adaptive_pret = plan(adaptive[0].detach(), self.adaptive_row, self.adaptive_col, "adaptive_")
        return support_prets, adaptive_pret

    def _aggregate(self, x_flat, adaptive, support_prets, adaptive_pret):
        """x_flat (N_pad, F) -> (K, N_pad, F): identity and each support
        applied, each cast to x_flat's dtype at the stack (JAX
        sparse_atgcn.py:376). The BSR kernel's sums are f32, so under bf16 a
        BSR support's hub and tail parts and the adaptive view's background
        are added to them in f32, as JAX's y + (...).astype(y.dtype) does."""
        outs = [x_flat]
        for i, pre_t in enumerate(support_prets):
            # JAX's order and form (sparse_atgcn.py:330-366): band, BSR, hub, tail
            sv, static = self._support(i), self._support_static[i]
            y = None
            if "band_packed" in sv:
                y = spmm_band_packed(sv["band_packed"], static["band_radius_static"], x_flat)
            elif "band_values" in sv:
                y = spmm_band(sv["band_values"], static["band_offsets_static"], x_flat)
            if self._has_bsr(sv):
                yb = spmm_pret(sv["values"], pre_t, sv["row"], sv["col"], x_flat, block=self.block,
                               row_ptr=sv["row_ptr"], schedule=self._schedule("support{}_schedule".format(i)))
                y = yb if y is None else y + yb
            if y is None:  # the split left nothing dense
                y = torch.zeros_like(x_flat)
            if "hub_values" in sv:
                y = y + spmm_hub(sv["hub_values"], sv["hub_cols"], x_flat)
            if "tail_w" in sv:
                # on the card in a fixed order (index_add_'s atomics are not); on
                # the CPU index_add_'s edge order, with JAX's per-add rounding
                order = ((sv["tail_ptr_src"], sv["tail_by_dst"], sv["tail_ptr_dst"]) if x_flat.is_cuda
                         else None)
                y = y + spmm_tail(sv["tail_w"], sv["tail_src"], sv["tail_dst"], x_flat, x_flat.shape[0], order)
            outs.append(y)
        if adaptive is not None:
            vals, background = adaptive
            y = spmm_pret(vals, adaptive_pret, self.adaptive_row, self.adaptive_col, x_flat,
                          block=self.block, row_ptr=self.adaptive_row_ptr,
                          schedule=self._schedule("adaptive_schedule"))
            if background is not None:
                # rank-1 exp(0) background of the dense reference softmax
                y = y + background.reshape(-1, 1) * x_flat.sum(dim=0, keepdim=True)
            outs.append(y)
        return torch.stack([o.to(x_flat.dtype) for o in outs], dim=0)

    def _cast(self, a):
        """`a` in the compute dtype, cast at use (parameters stay f32)."""
        return a if self.compute_dtype is None else a.to(self.compute_dtype)

    def _mix(self, h_stack, layer, cell):
        """h_stack (K, N, B, C) -> (N, B, out) through the weight pool."""
        pool = self._cast(getattr(self, "l{}_{}_pool".format(layer, cell)))
        bias = self._cast(getattr(self, "l{}_{}_bias".format(layer, cell)))
        if self.node_conditioned == "factored":
            emb = self._cast(self.node_emb)
            u = torch.einsum("knbi,dkio->nbdo", h_stack, pool)
            out = torch.einsum("nbdo,nd->nbo", u, emb)
            return out + (emb @ bias)[:, None, :]
        # sum of K full-row products, in the JAX package's order
        kk, n, b, ii = h_stack.shape
        out = h_stack[0].reshape(n * b, ii) @ pool[0]
        for k in range(1, kk):
            out = out + h_stack[k].reshape(n * b, ii) @ pool[k]
        return out.reshape(n, b, -1) + bias[0][None, None, :]

    # ---------------------------------------------------------------- forward
    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        """``train`` and ``generator`` are accepted for the executor's loss:
        the model has no dropout."""
        b, t, n, _ = x.shape
        if n != self.num_nodes:
            raise ValueError("expected padded node dim {}, got {}".format(self.num_nodes, n))
        adaptive = self._adaptive_values() if self.has_adaptive else None
        support_prets, adaptive_pret = self._precompute_transposes(adaptive)
        hdim = self.hidden_dim

        def aggregate(x_flat):
            return self._aggregate(x_flat, adaptive, support_prets, adaptive_pret)

        cdt = self.compute_dtype
        current = self._cast(x).permute(1, 2, 0, 3)  # (T, N, B, C): SpMM consumes (N_pad, B*C)
        for layer in range(self.num_layers):
            dim_in = current.shape[-1]
            # the input part of every step, aggregated at once; (N, T*B*C)
            # in row-major order (at B*C = 1 the reshape alone is a strided view)
            flat = current.reshape(t, n, b * dim_in).transpose(0, 1).reshape(n, t * b * dim_in).contiguous()
            del current  # the copy in `flat` is all the rest of the layer reads
            agg_x = aggregate(flat)
            del flat
            # (T, K, N, B, C), one view per step: unbind's backward stacks the
            # steps' gradients once, where indexing would add a zero-filled
            # copy of the whole stack per step (6 GB a step in bf16 at 1M nodes)
            agg_xs = agg_x.reshape(-1, n, t, b, dim_in).permute(2, 0, 1, 3, 4).unbind(0)
            del agg_x

            def step(hstate, agg_x_t, layer=layer):
                if cdt is not None:
                    # where JAX rounds the per-step input's cotangent (sparse_atgcn.py:433-439)
                    agg_x_t = round_cotangent(agg_x_t, cdt)
                agg_h = aggregate(hstate.reshape(n, b * hdim)).reshape(-1, n, b, hdim)
                z_r = torch.sigmoid(self._mix(torch.cat([agg_x_t, agg_h], dim=-1), layer, "gate"))
                z, r = torch.split(z_r, hdim, dim=-1)
                agg_zh = aggregate((z * hstate).reshape(n, b * hdim)).reshape(-1, n, b, hdim)
                hc = torch.tanh(self._mix(torch.cat([agg_x_t, agg_zh], dim=-1), layer, "update"))
                return r * hstate + (1.0 - r) * hc

            hstate = agg_xs[0].new_zeros(n, b, hdim)
            states = []
            for ti in range(t):
                if self.remat and torch.is_grad_enabled():
                    hstate = checkpoint(step, hstate, agg_xs[ti], use_reentrant=False)
                else:
                    hstate = step(hstate, agg_xs[ti])
                states.append(hstate)
            del agg_xs
            current = torch.stack(states)  # (T, N, B, H)
            del states
            if cdt is not None:
                # and the layer-output stack's (sparse_atgcn.py:461-465)
                current = round_cotangent(current, cdt)

        out = current[-1] @ self._cast(self.end_kernel) + self._cast(self.end_bias[0])
        out = out.reshape(n, b, self.output_window, self.output_dim)
        return out.permute(1, 2, 0, 3).float()  # predictions in f32, as JAX returns them


_COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _compute_dtype(config):
    name = config.get("compute_dtype", None)
    if name not in _COMPUTE_DTYPES:
        raise ValueError("SparseATGCN compute_dtype must be one of {}, got {!r}".format(
            sorted(k for k in _COMPUTE_DTYPES if k), name))
    return _COMPUTE_DTYPES[name]


def _unsupported(config):
    """NotImplementedError for the JAX package's option this port lacks: the
    multi-chip backend."""
    if config.get("node_parallel", False):
        raise NotImplementedError("node_parallel (the edge-partitioned multi-chip backend) is not "
                                  "ported yet: ROADMAP.md A.7 (spmm_boundary/spmm_sharded)")


def _band_support(graph: BandGraph, config):
    """The band decomposition's support and adaptive pattern (JAX
    sparse_atgcn.py:566-612): the band as planes or packed rows, the hub
    columns of the remaining edges, and a COO tail of the rest; the adaptive
    view samples the band's tiles, in row-major order."""
    offsets = np.asarray(graph.offsets)
    if config.get("graph_band_packed", False):
        radius = band_radius(offsets)
        support = {"band_packed": pack_band_rows(graph.band_values, offsets, radius),
                   "band_radius_static": radius, "band_offsets_static": offsets}
    else:
        support = {"band_values": graph.band_values, "band_offsets_static": offsets}
    hy = split_hub_columns(graph.rest_src, graph.rest_dst, graph.rest_w, graph.num_nodes, graph.block)
    if hy.num_hubs > 0:
        support["hub_values"] = hy.hub_values
        support["hub_cols"] = hy.hub_cols
    non_hub = ~np.isin(graph.rest_dst, hy.hub_cols)
    if non_hub.any():
        order = np.argsort(graph.rest_src[non_hub], kind="stable")
        support["tail_w"] = graph.rest_w[non_hub][order]
        support["tail_src"] = graph.rest_src[non_hub][order].astype(np.int32)
        support["tail_dst"] = graph.rest_dst[non_hub][order].astype(np.int32)
    adaptive = None
    if config.get("adpadj", "none") != "none":
        nb = graph.num_row_blocks
        rows = [np.arange(max(0, -int(o)), min(nb, nb - int(o))) for o in offsets]
        cols = [r + int(o) for r, o in zip(rows, offsets)]
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        order = np.lexsort((cols, rows))
        adaptive = (rows[order].astype(np.int32), cols[order].astype(np.int32))
    return support, adaptive


def _bsr_support(graph, config):
    """A BSR support, with the hub columns of a HybridGraph or the COO tail of
    a TailGraph; the adaptive view samples the BSR remainder's tiles, or
    only the `adaptive_max_blocks` statically heaviest (JAX
    sparse_atgcn.py:630-658)."""
    extra = {}
    if isinstance(graph, HybridGraph):
        extra = {"hub_values": graph.hub_values, "hub_cols": graph.hub_cols}
        graph = graph.bsr
    elif isinstance(graph, TailGraph):
        extra = {"tail_w": graph.tail_w, "tail_src": graph.tail_src, "tail_dst": graph.tail_dst}
        graph = graph.bsr
    support = {"values": graph.values, "row": graph.row_of, "col": graph.col_of, **extra}
    adaptive = None
    if config.get("adpadj", "none") != "none":
        row_np, col_np = graph.row_of, graph.col_of
        max_blocks = config.get("adaptive_max_blocks", 0)
        if max_blocks and graph.values.shape[0] > max_blocks:
            mass = np.abs(graph.values).sum(axis=(1, 2))
            keep = np.sort(np.argpartition(-mass, max_blocks)[:max_blocks])
            row_np, col_np = row_np[keep], col_np[keep]
        adaptive = (row_np, col_np)
    return support, adaptive


def build_sparse_atgcn(graph, config, device=None, generator: Optional[torch.Generator] = None) -> SparseATGCN:
    """SparseATGCN over one static support, a BSRGraph, HybridGraph,
    TailGraph or BandGraph (plus the adaptive view unless ``adpadj`` is
    'none'), on `device` (CUDA unless "cpu" is asked for), its weights drawn
    from `generator` (default: seeded with config['seed'])."""
    if isinstance(graph, BandGraph):
        support, adaptive = _band_support(graph, config)
    elif isinstance(graph, (BSRGraph, HybridGraph, TailGraph)):
        support, adaptive = _bsr_support(graph, config)
    else:
        raise TypeError("build_sparse_atgcn takes a BSRGraph, HybridGraph, TailGraph or BandGraph, "
                        "got {}".format(type(graph).__name__))
    _unsupported(config)
    device = resolve_device(device)
    model = SparseATGCN(
        num_nodes=graph.padded_nodes,
        output_window=config.get("output_window", 1),
        output_dim=config.get("output_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        num_layers=config.get("num_layers", 2),
        embed_dim_adj=config.get("embed_dim_adj", 16),
        supports=(support,),
        adaptive_pattern=adaptive,
        node_conditioned=config.get("node_conditioned", "off"),
        embed_dim_node=config.get("embed_dim_node", 8),
        block=graph.block,
        remat=config.get("remat", False),
        adaptive_softmax=config.get("adaptive_softmax", "sampled"),
        device=device,
        compute_dtype=_compute_dtype(config),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
    model.init_parameters(generator)
    return model.eval()


def build_sparse_atgcn_from_feature(config, data_feature, device=None,
                                    generator: Optional[torch.Generator] = None) -> SparseATGCN:
    """Registry builder: the graph arrives as data_feature['bsr_graph']."""
    return build_sparse_atgcn(data_feature["bsr_graph"], config, device=device, generator=generator)
