"""MultiATGCN as a PyTorch nn.Module, with its training backward.

Counterpart of multistgraph_tpu/models/multi_atgcn.py (ref:
libcity/model/traffic_flow_prediction/MultiATGCN.py:59-430): multi-head
temporal fusion, the static-conditioned initial state, the
adaptive-graph-convolution GRU encoder with node-conditioned weights and a
learned per-(layer, step) mix with a residual GRU, and the conv head. The
JAX package's design carries over: supports built once per forward, the
support gate folded into the pool, the x-part of every step hoisted out of
the scan into one batched contraction, node-conditioned weights expanded
once per forward. The scan is a Python loop over T.

Three numeric modes, as in JAX:
  * ``compute_dtype=None``: exact f32. The hoisted per-step stacks go
    through the layout-copy kernel (ops/layout.py), once per layer;
  * ``compute_dtype='bfloat16'``: graph and weight contractions on
    bf16-rounded operands with f32 accumulation;
  * ``weight_stream_quant='int8'`` with any compute dtype (bfloat16,
    float32 or float16; and fused_bptt, and the graph conv on): the
    N-major encoder whose h-side weights are quantized per forward and
    applied by the int8 kernel (ops/node_apply.py) to activations in the
    compute dtype, two launches per step per layer.

bf16 rounding points follow JAX exactly: an operand is rounded to bf16 and
then contracted in f32 (bf16 -> f32 is exact), and a result JAX leaves in
bf16 is rounded once. ``torch.einsum`` on bf16 tensors would round
elsewhere.

Training: each encoder layer is a ``torch.autograd.Function`` with the
JAX package's hand-written BPTT (``fused_atgru_layer`` and, on the int8
path, ``fused_atgru_layer_q8``, whose reverse loop launches the transposed
int8 kernel B2t); ``fused_bptt=False`` takes plain autograd of the step
loop instead. Dropout acts on the encoder states in train mode.

Seeds: ``forward_seeds`` runs S models of this architecture at once, the
counterpart of the JAX module under ``jax.vmap`` (parallel/multiseed.py):
every computation carries a leading seed axis, each seed with its own
parameters, and ``forward`` is the case S = 1.

Parameter names and layouts are the reference's torch ``state_dict``
(Linear weights (out, in), ``end_conv.weight`` (out, t_conv, 1, H)), so a
reference checkpoint loads as it is.
"""

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multistgraph_tpu_torch.graph import views as graph_views
from multistgraph_tpu_torch.models import initializers
from multistgraph_tpu_torch.ops import layout as layout_ops
from multistgraph_tpu_torch.ops.node_apply import (
    _pad_nodes,
    node_apply_q8,
    node_apply_q8_t,
    quantize_node_weights,
)
from multistgraph_tpu_torch.utils import resolve_device

HOURS_PER_BLOCK = 24  # the reference hardcodes 24-step fusion blocks (ref :373-393)

def _round(a: torch.Tensor, dtype) -> torch.Tensor:
    """a rounded to `dtype` and widened back to f32 (identity for dtype None)."""
    return a if dtype is None else a.to(dtype).float()


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """einsum of `dtype`-rounded operands, accumulated in f32."""
    return torch.einsum(spec, _round(a, dtype), _round(b, dtype))


class _Affine(nn.Module):
    """A Linear layer's parameters, (out, in) weight and (out,) bias."""

    def __init__(self, dim_in: int, dim_out: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim_out, dim_in, device=device))
        self.bias = nn.Parameter(torch.empty(dim_out, device=device))


class _AGCNCell(nn.Module):
    def __init__(self, e: int, ks: int, dim_in: int, dim_out: int, device):
        super().__init__()
        self.weights_g = nn.Parameter(torch.empty(ks, 1, 1, device=device))
        self.weights_pool = nn.Parameter(torch.empty(e, ks, dim_in, dim_out, device=device))
        self.bias_pool = nn.Parameter(torch.empty(e, dim_out, device=device))


class _GatePair(nn.Module):
    """The gate and update cells of one GRU layer."""

    def __init__(self, gate: nn.Module, update: nn.Module):
        super().__init__()
        self.gate = gate
        self.update = update


class _Encoder(nn.Module):
    def __init__(self, num_layers, input_window, feature_final, hidden, e, ks, gcn_off, device):
        super().__init__()
        self.weights_gru = nn.Parameter(torch.empty(num_layers, input_window, device=device))
        self.agru_cells = nn.ModuleList()  # empty when gcn_off
        self.res_cells = nn.ModuleList()
        for layer in range(num_layers):
            dim_in = feature_final if layer == 0 else hidden
            if not gcn_off:
                self.agru_cells.append(_GatePair(
                    _AGCNCell(e, ks, dim_in + hidden, 2 * hidden, device),
                    _AGCNCell(e, ks, dim_in + hidden, hidden, device)))
            self.res_cells.append(_GatePair(
                _Affine(dim_in + hidden, 2 * hidden, device),
                _Affine(dim_in + hidden, hidden, device)))


class _StaticInit(nn.Module):
    def __init__(self, q: int, hidden: int, device):
        super().__init__()
        self.embd = _Affine(q, hidden, device)


class _EndConv(nn.Module):
    """The conv head's parameters in torch Conv2d layout (out, t_conv, 1, H)."""

    def __init__(self, out_channels: int, t_conv: int, hidden: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, t_conv, 1, hidden, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))


# --------------------------------------------------------------------------
# Encoder steps and the hand-written BPTT (multi_atgcn.py:114-459).
#
# Under autograd, one encoder layer is one torch.autograd.Function, as the
# JAX package makes it one custom VJP. Its forward runs the step loop
# without recording a graph and stacks the small per-step intermediates
# (zr, hc, h_agru, zr2, hc_res) in the compute dtype. Its backward
# recomputes the two large aggregation stacks hh/hzh in two bulk einsums,
# runs the reverse loop, whose only accumulator is the supports cotangent
# (f32), and forms each weight gradient in one contraction over (T, B),
# the residual-GRU kernels' too (a per-step accumulation of those small
# products runs a long, thin GEMM a step, which cuBLAS splits over K for
# one seed and not for a batch of seeds). Letting autograd trace the loop
# instead would accumulate an (N,K,I,O) weight cotangent at every step.
# Without autograd (serving, validation) the encoder runs the same steps
# and stacks nothing.
#
# Every tensor carries a leading seed axis S, the counterpart of the JAX
# package's vmap over seeds (parallel/multiseed.py): one model is S = 1,
# and S seeds trained together run every contraction once over all of
# them. Each seed keeps its own supports, node-conditioned weights,
# residual kernels and biases; the node-conditioned applies see the seeds
# as S*N nodes, so kernels B2/B2t launch as often at any S.
# --------------------------------------------------------------------------

_AGG_SPEC = "sknm,sbmc->sbknc"         # supports @ h (per scan step)
_APPLY_SPEC = "sbkni,snkio->sbno"      # node-conditioned weight apply
_BULK_AGG_SPEC = "sknm,tsbmc->snkbtc"  # bulk recompute of hh/hzh stacks (bwd)
_DW_SPEC = "snkbti,tsbno->snkio"       # one-shot weight-gradient contraction
_DAPPLY_SPEC = "sbno,snkio->sbkni"     # W^T apply in the reverse loop
_DSUP_SPEC = "sbknc,sbmc->sknm"        # supports-cotangent accumulation
_DAGGT_SPEC = "sknm,sbknc->sbmc"       # supports^T applied to dhh/dhzh
# the same for the N-major int8 layer (multi_atgcn.py:396-447)
_Q8_AGG_SPEC = "sknm,smbc->snbkc"
_Q8_BULK_AGG_SPEC = "sknm,tsmbc->snkbtc"
_Q8_DW_SPEC = "snkbti,tsnbo->snkio"
_Q8_DSUP_SPEC = "snbkc,smbc->sknm"
_Q8_DAGGT_SPEC = "sknm,snbkc->smbc"


def _bmm_split_k(a, b, chunk=4096):
    """torch.bmm of (S, M, K) @ (S, K, N) with a long K cut into chunks of
    `chunk` whose products are summed after: cuBLAS splits a long K over
    blocks for one GEMM but not for a batch of a few, and the per-seed
    weight gradients are such batches (K = T*N*B rows, M x N a weight).
    One seed's product stays one GEMM, which cuBLAS splits itself."""
    s, m, k = a.shape
    if s == 1:
        return torch.mm(a[0], b[0])[None]
    parts = -(-k // chunk)
    if parts == 1:
        return torch.bmm(a, b)
    pad = parts * chunk - k
    if pad:
        a, b = F.pad(a, (0, pad)), F.pad(b, (0, 0, 0, pad))
    a = a.reshape(s, m, parts, chunk).transpose(1, 2).reshape(s * parts, m, chunk)
    return torch.bmm(a, b.reshape(s * parts, chunk, -1)).view(s, parts, m, -1).sum(1)


class _SeedMatmul(torch.autograd.Function):
    """(S, M, K) @ (S, K, N), each seed its own product; the backward's
    products of long contraction through ``_bmm_split_k``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = _bmm_split_k(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        db = _bmm_split_k(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return da, db


def _seed_project(x, w, seed_dim):
    """x (..., C) with its seed axis at `seed_dim` times w (S, C, D), each
    seed its own w; the seed axis stays where it was."""
    x = x.movedim(seed_dim, 0)
    out = _SeedMatmul.apply(x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],)).movedim(0, seed_dim)


def _seed_mm(a, w):
    """a (S, ..., I) @ w (S, I, O), each seed with its own w: (S, ..., O)."""
    s = a.shape[0]
    return torch.bmm(a.reshape(s, -1, a.shape[-1]), w).reshape(a.shape[:-1] + (w.shape[-1],))


def _per_seed(v, ndim):
    """A (S,) per-seed value shaped to broadcast over (S, ...) of rank `ndim`."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _atgru_step(h_prev, xs, supports, wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, dtype):
    """One B-major ATGRU + residual step; h_prev (S, B, N, H). Returns the
    new state and the intermediates the backward reads."""
    gate_x_t, upd_x_t, rg_x_t, ru_x_t, w_t = xs
    hh = _mm(_AGG_SPEC, supports, h_prev, dtype)
    zr = torch.sigmoid(gate_x_t + _mm(_APPLY_SPEC, hh, wg_h, dtype) + bg[:, None])
    z, r = torch.chunk(zr, 2, dim=-1)
    hzh = _mm(_AGG_SPEC, supports, z * h_prev, dtype)
    hc = torch.tanh(upd_x_t + _mm(_APPLY_SPEC, hzh, wu_h, dtype) + bu[:, None])
    h_agru = r * h_prev + (1.0 - r) * hc
    zr2 = torch.sigmoid(rg_x_t + _seed_mm(h_agru, rg_h) + rg_b[:, None, None])
    z2, r2 = torch.chunk(zr2, 2, dim=-1)
    hc_res = torch.tanh(ru_x_t + _seed_mm(z2 * h_agru, ru_h) + ru_b[:, None, None])
    h_res = r2 * h_agru + (1.0 - r2) * hc_res
    w_t = _per_seed(w_t, h_prev.dim())
    return w_t * h_agru + (1.0 - w_t) * h_res, (zr, hc, h_agru, zr2, hc_res)


def _quantize_h_weights(wg_h, wu_h, block=32):
    """Quantize the h-side weights (..., N, K, I, O) per forward as
    (nodes, K*I, O), the seeds' nodes one after another (each scale is one
    node's, so none spans two seeds), and zero-pad the nodes to a block
    multiple, as the JAX package does for its 32-node kernel blocks (the
    CUDA kernel ignores the pad rows)."""
    kk, ii, og = wg_h.shape[-3:]
    ou = wu_h.shape[-1]
    n = wg_h.shape[:-3].numel()
    n_pad = -(-n // block) * block
    wgq, wgs = quantize_node_weights(wg_h.reshape(n, kk * ii, og))
    wuq, wus = quantize_node_weights(wu_h.reshape(n, kk * ii, ou))
    return (_pad_nodes(wgq, 0, n_pad), _pad_nodes(wgs, 0, n_pad),
            _pad_nodes(wuq, 0, n_pad), _pad_nodes(wus, 0, n_pad))


def _bf16_matmul(a, b_rounded, dtype):
    """``cast(a) @ cast(b)`` per seed with its result in the compute dtype
    (bf16 on the bf16 path), as JAX computes it."""
    return _seed_mm(_round(a, dtype), b_rounded).to(dtype)


def _node_apply(apply, act, wq, scale):
    """Kernel B2 or B2t on (S, N, B, C) activations, the seeds' nodes as
    S*N nodes of one launch."""
    s, n, b, _ = act.shape
    return apply(act.reshape(s * n, b, -1), wq, scale).reshape(s, n, b, -1)


def _atgru_step_q8(h_prev, xs, supports_r, wq8, bg, bu, rg_h_r, ru_h_r, rg_b, ru_b, dtype):
    """One N-major step streaming int8 weights; h_prev (S, N, B, H) f32.

    supports_r, rg_h_r, ru_h_r are pre-rounded to the compute dtype (the
    per-step cast of a loop invariant). hh/hzh are cast to it after the
    aggregation and the int8 apply returns f32, so the carry is promoted to
    f32 as in JAX.
    Returns the new state and the intermediates the backward reads.
    """
    wgq, wgs, wuq, wus = wq8
    s, n, b, _ = h_prev.shape
    gate_x_t, upd_x_t, rg_x_t, ru_x_t, w_t = xs
    hh = torch.einsum(_Q8_AGG_SPEC, supports_r, _round(h_prev, dtype))
    hh = hh.to(dtype).reshape(s, n, b, -1).contiguous()
    zr = torch.sigmoid(gate_x_t + _node_apply(node_apply_q8, hh, wgq, wgs) + bg[:, :, None])
    z, r = torch.chunk(zr, 2, dim=-1)
    hzh = torch.einsum(_Q8_AGG_SPEC, supports_r, _round(z * h_prev, dtype))
    hzh = hzh.to(dtype).reshape(s, n, b, -1).contiguous()
    hc = torch.tanh(upd_x_t + _node_apply(node_apply_q8, hzh, wuq, wus) + bu[:, :, None])
    h_agru = r * h_prev + (1.0 - r) * hc
    zr2 = torch.sigmoid(rg_x_t + _bf16_matmul(h_agru, rg_h_r, dtype) + rg_b[:, None, None])
    z2, r2 = torch.chunk(zr2, 2, dim=-1)
    hc_res = torch.tanh(ru_x_t + _bf16_matmul(z2 * h_agru, ru_h_r, dtype) + ru_b[:, None, None])
    h_res = r2 * h_agru + (1.0 - r2) * hc_res
    w_t = _per_seed(w_t, h_prev.dim())
    return w_t * h_agru + (1.0 - w_t) * h_res, (zr, hc, h_agru, zr2, hc_res)


def _sum_outer(a, b):
    """einsum('ts..c,ts..o->sco') over all dims but the seed's (dim 1 of
    the per-step stacks), operands widened to f32."""
    a, b = a.movedim(1, 0), b.movedim(1, 0)
    s = a.shape[0]
    return _bmm_split_k(a.reshape(s, -1, a.shape[-1]).float().transpose(1, 2), b.reshape(s, -1, b.shape[-1]).float())


def _res_kernel_grads(stacks, dpre_rg_s, dpre_ru_s):
    """The residual GRU's h-side kernel gradients, each one contraction
    over (T, nodes, batch) after the reverse loop (the JAX package
    accumulates them in its loop; only the order of the sums differs):
    d_rg_h = h_agru^T dpre_rg, d_ru_h = (z2 h_agru)^T dpre_ru."""
    h_agru_s = stacks[2]
    z2_s = torch.chunk(stacks[3], 2, dim=-1)[0]
    return _sum_outer(h_agru_s, dpre_rg_s), _sum_outer(z2_s * h_agru_s, dpre_ru_s)


def _step_backward(carry, xs, supports, rg_h, ru_h, dtype, apply_t, dsup_spec, daggt_spec):
    """One reverse step (multi_atgcn.py:198-234 and :400-435), for either
    layout: ``apply_t(name, dpre)`` applies the transposed node-conditioned
    weights of cell ``name`` ("gate" or "update") to a pre-activation
    cotangent. Intermediates may be bf16: every mixed product promotes to
    f32, and a product of two bf16 terms stays bf16, as in JAX."""
    dh, d_sup = carry
    dy, h_prev, zr, hc, h_agru, zr2, hc_res, w_t = xs
    w_t = _per_seed(w_t, dh.dim())
    dh = dh + dy
    z, r = torch.chunk(zr, 2, dim=-1)
    z2, r2 = torch.chunk(zr2, 2, dim=-1)
    h_res = r2 * h_agru + (1.0 - r2) * hc_res
    # mix: h_new = w_t h_agru + (1-w_t) h_res
    dw_t = ((h_agru - h_res) * dh).sum(tuple(range(1, dh.dim())))
    dh_agru = w_t * dh
    dh_res = (1.0 - w_t) * dh
    # residual GRU backward
    dr2 = (h_agru - hc_res) * dh_res
    dh_agru = dh_agru + r2 * dh_res
    dpre_ru = (1.0 - r2) * dh_res * (1.0 - hc_res * hc_res)
    dz2h = _seed_mm(dpre_ru, ru_h.transpose(1, 2))
    dz2 = dz2h * h_agru
    dh_agru = dh_agru + dz2h * z2
    dpre_rg = torch.cat([dz2, dr2], dim=-1) * zr2 * (1.0 - zr2)
    dh_agru = dh_agru + _seed_mm(dpre_rg, rg_h.transpose(1, 2))
    # AGRU backward: h_agru = r h_prev + (1-r) hc
    dr = (h_prev - hc) * dh_agru
    dh_prev = r * dh_agru
    dpre_u = (1.0 - r) * dh_agru * (1.0 - hc * hc)
    dhzh = apply_t("update", dpre_u)
    d_sup = d_sup + _mm(dsup_spec, dhzh, z * h_prev, dtype)
    dzh = _mm(daggt_spec, supports, dhzh, dtype)
    dz = dzh * h_prev
    dh_prev = dh_prev + dzh * z
    dpre_g = torch.cat([dz, dr], dim=-1) * zr * (1.0 - zr)
    dhh = apply_t("gate", dpre_g)
    d_sup = d_sup + _mm(dsup_spec, dhh, h_prev, dtype)
    dh_prev = dh_prev + _mm(daggt_spec, supports, dhh, dtype)
    return (dh_prev, d_sup), (dpre_g, dpre_u, dpre_rg, dpre_ru, dw_t)


def _scan_forward(step, state0, xs_seq, keep):
    """Run `step` over T; returns the stacked states and the stacked
    intermediates, each passed through `keep`."""
    states, inters = [], []
    h = state0
    for xs in zip(*xs_seq):
        h, inter = step(h, xs)
        states.append(h)
        inters.append(tuple(keep(a) for a in inter))
    return torch.stack(states), [torch.stack(s) for s in zip(*inters)]


def _scan_backward(dstates, state0, states, inter_stacks, w_seq, carry, step_back):
    """The reverse loop; returns the final carry, the stacked per-step
    cotangents (dpre_g, dpre_u, dpre_rg, dpre_ru, dw_seq) and the stacked
    previous states h_{t-1}."""
    h_prev_s = torch.cat([state0[None], states[:-1]], dim=0)
    outs = []
    for t in reversed(range(states.shape[0])):
        xs = (dstates[t], h_prev_s[t]) + tuple(s[t] for s in inter_stacks) + (w_seq[t],)
        carry, out = step_back(carry, xs)
        outs.append(out)
    return carry, [torch.stack(s[::-1]) for s in zip(*outs)], h_prev_s


class _FusedATGRULayer(torch.autograd.Function):
    """B-major encoder layer (multi_atgcn.py:141-263): gate_x/upd_x/rg_x/ru_x
    (T,S,B,N,*), w_seq (T,S), supports (S,K,N,N), per-seed weights (S,...),
    state0 (S,B,N,H) -> states (T,S,B,N,H). dtype None (exact f32) or
    torch.bfloat16 (bf16-rounded contraction operands, f32 sums)."""

    @staticmethod
    def forward(ctx, dtype, gate_x, upd_x, rg_x, ru_x, w_seq, supports,
                wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state0):
        def step(h, xs):
            return _atgru_step(h, xs, supports, wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, dtype)

        keep = (lambda a: a) if dtype is None else (lambda a: a.to(dtype))
        states, stacks = _scan_forward(step, state0, (gate_x, upd_x, rg_x, ru_x, w_seq), keep)
        ctx.dtype = dtype
        ctx.dtypes = tuple(a.dtype for a in (gate_x, upd_x, rg_x, ru_x, wg_h, wu_h))
        ctx.save_for_backward(w_seq, supports, wg_h, wu_h, rg_h, ru_h, state0, states, *stacks)
        return states

    @staticmethod
    def backward(ctx, dstates):
        w_seq, supports, wg_h, wu_h, rg_h, ru_h, state0, states, *stacks = ctx.saved_tensors
        dtype = ctx.dtype
        weights = {"gate": wg_h, "update": wu_h}

        def step_back(carry, xs):
            return _step_backward(carry, xs, supports, rg_h, ru_h, dtype,
                                  lambda cell, d: _mm(_DAPPLY_SPEC, d, weights[cell], dtype),
                                  _DSUP_SPEC, _DAGGT_SPEC)

        carry0 = (torch.zeros_like(state0), torch.zeros_like(supports))
        (dstate0, d_sup), cots, h_prev_s = _scan_backward(
            dstates, state0, states, stacks, w_seq, carry0, step_back)
        dpre_g_s, dpre_u_s, dpre_rg_s, dpre_ru_s, dw_seq = cots
        d_rg_h, d_ru_h = _res_kernel_grads(stacks, dpre_rg_s, dpre_ru_s)
        # the two large aggregation stacks, recomputed in bulk for the dW
        # contractions only (the reverse loop never reads them)
        hh_s = _mm(_BULK_AGG_SPEC, supports, h_prev_s, dtype)
        z_s = torch.chunk(stacks[0], 2, dim=-1)[0]
        hzh_s = _mm(_BULK_AGG_SPEC, supports, z_s * h_prev_s, dtype)
        gx_t, ux_t, rgx_t, rux_t, wg_t, wu_t = ctx.dtypes
        d_wg_h = _mm(_DW_SPEC, hh_s, dpre_g_s, dtype).to(wg_t)
        d_wu_h = _mm(_DW_SPEC, hzh_s, dpre_u_s, dtype).to(wu_t)
        return (None, dpre_g_s.to(gx_t), dpre_u_s.to(ux_t), dpre_rg_s.to(rgx_t),
                dpre_ru_s.to(rux_t), dw_seq, d_sup, d_wg_h, d_wu_h,
                dpre_g_s.sum((0, 2)), dpre_u_s.sum((0, 2)), d_rg_h, d_ru_h,
                dpre_rg_s.sum((0, 2, 3)), dpre_ru_s.sum((0, 2, 3)), dstate0)


class _FusedATGRULayerQ8(torch.autograd.Function):
    """N-major, int8-weight-streamed twin (multi_atgcn.py:341-459):
    gate_x/upd_x/rg_x/ru_x (T,S,N,B,*) in the compute dtype, state0
    (S,N,B,H) -> states (T,S,N,B,H). The h-side weights are quantized once
    per call; the forward applies them with B2 (two launches per step) and
    the reverse loop with B2t (two per step), the seeds' nodes in one
    launch. The weight gradients are straight-through: the full-precision
    (T,B) contraction of the exact path."""

    @staticmethod
    def forward(ctx, dtype, gate_x, upd_x, rg_x, ru_x, w_seq, supports,
                wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state0):
        wq8 = _quantize_h_weights(wg_h, wu_h)
        supports_r = _round(supports, dtype)
        rg_h_r, ru_h_r = _round(rg_h, dtype), _round(ru_h, dtype)

        def step(h, xs):
            return _atgru_step_q8(h, xs, supports_r, wq8, bg, bu, rg_h_r, ru_h_r, rg_b, ru_b, dtype)

        states, stacks = _scan_forward(step, state0, (gate_x, upd_x, rg_x, ru_x, w_seq),
                                       lambda a: a.to(dtype))
        ctx.dtype = dtype
        ctx.dtypes = tuple(a.dtype for a in (gate_x, upd_x, rg_x, ru_x, wg_h, wu_h))
        ctx.kk = wg_h.shape[-3]
        ctx.save_for_backward(w_seq, supports, rg_h, ru_h, state0, *wq8, states, *stacks)
        return states

    @staticmethod
    def backward(ctx, dstates):
        w_seq, supports, rg_h, ru_h, state0, wgq, wgs, wuq, wus, states, *stacks = ctx.saved_tensors
        dtype = ctx.dtype
        s, n, b, hdim = state0.shape
        weights = {"gate": (wgq, wgs), "update": (wuq, wus)}

        def apply_t(cell, dpre):
            return _node_apply(node_apply_q8_t, dpre.to(dtype), *weights[cell]).reshape(s, n, b, ctx.kk, hdim)

        def step_back(carry, xs):
            return _step_backward(carry, xs, supports, rg_h, ru_h, dtype, apply_t,
                                  _Q8_DSUP_SPEC, _Q8_DAGGT_SPEC)

        carry0 = (torch.zeros_like(state0), torch.zeros_like(supports))
        (dstate0, d_sup), cots, h_prev_s = _scan_backward(
            dstates, state0, states, stacks, w_seq, carry0, step_back)
        dpre_g_s, dpre_u_s, dpre_rg_s, dpre_ru_s, dw_seq = cots
        d_rg_h, d_ru_h = _res_kernel_grads(stacks, dpre_rg_s, dpre_ru_s)
        hh_s = _mm(_Q8_BULK_AGG_SPEC, supports, h_prev_s, dtype)
        z_s = torch.chunk(stacks[0], 2, dim=-1)[0]
        hzh_s = _mm(_Q8_BULK_AGG_SPEC, supports, z_s * h_prev_s, dtype)
        gx_t, ux_t, rgx_t, rux_t, wg_t, wu_t = ctx.dtypes
        d_wg_h = _mm(_Q8_DW_SPEC, hh_s, dpre_g_s, dtype).to(wg_t)
        d_wu_h = _mm(_Q8_DW_SPEC, hzh_s, dpre_u_s, dtype).to(wu_t)
        return (None, dpre_g_s.to(gx_t), dpre_u_s.to(ux_t), dpre_rg_s.to(rgx_t),
                dpre_ru_s.to(rux_t), dw_seq, d_sup, d_wg_h, d_wu_h,
                dpre_g_s.sum((0, 3)), dpre_u_s.sum((0, 3)), d_rg_h, d_ru_h,
                dpre_rg_s.sum((0, 2, 3)), dpre_ru_s.sum((0, 2, 3)), dstate0)


def fused_atgru_layer(dtype, gate_x, upd_x, rg_x, ru_x, w_seq, supports,
                      wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state0):
    """States (T,B,N,H) of one B-major encoder layer of one model, with the
    hand-written BPTT; arguments in the order of the JAX ``fused_atgru_layer``."""
    seq = [a.unsqueeze(1) for a in (gate_x, upd_x, rg_x, ru_x, w_seq)]
    rest = [a.unsqueeze(0) for a in (supports, wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state0)]
    return _FusedATGRULayer.apply(dtype, *seq, *rest)[:, 0]


def fused_atgru_layer_q8(dtype, gate_x, upd_x, rg_x, ru_x, w_seq, supports,
                         wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state0):
    """States (T,N,B,H) of one N-major int8 encoder layer of one model, with
    the hand-written BPTT; arguments in the order of the JAX ``fused_atgru_layer_q8``."""
    seq = [a.unsqueeze(1) for a in (gate_x, upd_x, rg_x, ru_x, w_seq)]
    rest = [a.unsqueeze(0) for a in (supports, wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state0)]
    return _FusedATGRULayerQ8.apply(dtype, *seq, *rest)[:, 0]


class MultiATGCN(nn.Module):
    """Input x: (B, T_total, N, F); output: (B, Tout, N, output_dim)."""

    # The executor and the service record its forward and training step as
    # CUDA graphs (executor/graphs.py): no host read, no data-dependent
    # shape, no CPU tensor made inside forward or the BPTT Functions, and
    # dropout draws from the generator it is handed.
    graph_safe = True
    # read by the multi-seed trainer (parallel/multiseed.py): S seeds run as
    # one widened forward through ``forward_seeds``
    seed_form = "widened"

    def __init__(self, *, num_nodes, input_window, output_window, start_dim, end_dim, ext_dim,
                 hidden_dim, num_layers, cheb_k, embed_dim_node, embed_dim_adj, adjtype, adpadj,
                 add_time_in_day, add_day_in_week, load_dynamic, gcn_off, fnn_off,
                 node_specific_off, len_closeness, len_period, len_trend, supports_static,
                 static_proj=None, fused_bptt=True, weight_stream_quant=None, compute_dtype=None,
                 dropout_rate=0.1, device="cpu"):
        super().__init__()
        self.num_nodes = num_nodes
        self.input_window = input_window
        self.output_window = output_window
        self.start_dim = start_dim
        self.end_dim = end_dim
        self.ext_dim = ext_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.cheb_k = cheb_k
        self.adjtype = adjtype
        self.adpadj = adpadj
        self.add_time_in_day = add_time_in_day
        self.add_day_in_week = add_day_in_week
        self.load_dynamic = load_dynamic
        self.gcn_off = gcn_off
        self.fnn_off = fnn_off
        self.node_specific_off = node_specific_off
        self.len_closeness = len_closeness
        self.len_period = len_period
        self.len_trend = len_trend
        self.fused_bptt = fused_bptt
        self.dropout_rate = dropout_rate  # on the encoder states, in train mode (JAX :493,925)
        self.weight_stream_quant = weight_stream_quant
        self.compute_dtype = None if compute_dtype is None else getattr(torch, compute_dtype)

        n, out, h = num_nodes, self.output_dim, hidden_dim
        e = 1 if node_specific_off else embed_dim_node
        if node_specific_off:
            # frozen all-ones embedding, not a parameter (MultiATGCN.py:350-354)
            self.register_buffer("node_emb", torch.ones(n, 1, device=device), persistent=False)
        else:
            self.node_emb = nn.Parameter(torch.empty(n, e, device=device))
        self.node_vec1 = nn.Parameter(torch.empty(n, embed_dim_adj, device=device))
        self.node_vec2 = nn.Parameter(torch.empty(embed_dim_adj, n, device=device))
        self.weight_ts = nn.ParameterList(
            [nn.Parameter(torch.empty(1, HOURS_PER_BLOCK, n, out, device=device))
             for _ in range(self.len_ts)])
        self.weight_tsg = nn.Parameter(torch.empty(self.len_ts, device=device))
        self.encoder = _Encoder(num_layers, input_window, self.feature_final, h, e,
                                self.num_supports, gcn_off, device)
        self.register_buffer("supports_static",
                             torch.as_tensor(supports_static, dtype=torch.float32, device=device),
                             persistent=False)
        if static_proj is not None:
            self.register_buffer("static_proj",
                                 torch.as_tensor(static_proj, dtype=torch.float32, device=device),
                                 persistent=False)
            self.static_initial_gru = _StaticInit(static_proj.shape[1], h, device)
        else:
            self.static_proj = None
        t_conv = 1 if fnn_off else input_window
        self.end_conv = _EndConv(output_window * out, t_conv, h, device)

    # ------------------------------------------------------------ properties
    @property
    def output_dim(self) -> int:
        return self.end_dim - self.start_dim

    @property
    def time_index_dim(self) -> int:
        if self.add_time_in_day and self.add_day_in_week:
            return 8
        if self.add_time_in_day:
            return 1
        if self.add_day_in_week:
            return 7
        return 0

    @property
    def feature_final(self) -> int:
        return self.output_dim + self.ext_dim

    @property
    def num_supports(self) -> int:
        """Total stacked supports = reference's cheb_ks (MultiATGCN.py:65-70)."""
        if self.adjtype == "multi" and self.adpadj in ("bidirection", "unidirection"):
            return 1 + (self.cheb_k - 1) * 4
        if self.adjtype == "multi":
            return 1 + (self.cheb_k - 1) * 3
        return self.cheb_k

    @property
    def len_ts(self) -> int:
        return (self.len_closeness + self.len_period + self.len_trend) // HOURS_PER_BLOCK

    @property
    def uses_int8_stream(self) -> bool:
        """The JAX package's dispatch condition (multi_atgcn.py:736-737)."""
        return (self.weight_stream_quant == "int8" and self.fused_bptt
                and self.compute_dtype is not None and not self.gcn_off)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator, overrides=None) -> None:
        """xavier_uniform (torch fans) for dim>1, U[0,1) for vectors, Linear
        weights as dense kernels; drawn on the CPU from `generator` in
        parameter order. `overrides` maps a name to a fixed initial value."""
        overrides = overrides or {}
        for name, p in self.named_parameters():
            if name in overrides:
                value = torch.as_tensor(np.asarray(overrides[name]), dtype=torch.float32)
            elif name.startswith(("encoder.res_cells.", "static_initial_gru.")) and p.dim() == 2:
                value = initializers.dense_kernel_init((p.shape[1], p.shape[0]), generator)
            else:
                value = initializers.torch_style_init(tuple(p.shape), generator)
            p.copy_(value)

    # ------------------------------------------------------------ components
    def seed_parameters(self) -> dict:
        """{name: (1, *shape)}: this model's parameters as one seed of
        ``forward_seeds``. Read by attribute, so ``torch.func.functional_call``
        (the quantized service's forward) substitutes its tensors."""
        return {name: functools.reduce(getattr, name.split("."), self)[None]
                for name, _ in self.named_parameters()}

    def _build_supports(self, p) -> torch.Tensor:
        """Stack all supports per seed (S, K_total, N, N), adaptive terms
        first (ref :87-101)."""
        s = p["weight_tsg"].shape[0]
        base = self.supports_static[None].expand((s,) + self.supports_static.shape)
        if self.adpadj == "none":
            return base
        if self.adpadj == "unidirection":
            logits = torch.relu(p["node_vec1"] @ p["node_vec2"])
        elif self.adpadj == "bidirection":
            emb = p["node_emb"]
            logits = torch.relu(emb @ emb.transpose(1, 2))
        else:
            raise ValueError("unknown adpadj {!r}".format(self.adpadj))
        adaptive = torch.softmax(logits, dim=2)
        eye = torch.eye(self.num_nodes, dtype=torch.float32, device=adaptive.device)
        terms = [adaptive]
        prev2, prev1 = eye, adaptive
        for _ in range(2, self.cheb_k):
            nxt = 2.0 * adaptive @ prev1 - prev2
            terms.append(nxt)
            prev2, prev1 = prev1, nxt
        adaptive_stack = torch.stack(terms, dim=1)
        if self.adjtype == "multi":
            return torch.cat([base[:, :1], adaptive_stack, base[:, 1:]], dim=1)
        return torch.cat([eye.expand(s, 1, -1, -1), adaptive_stack], dim=1)

    def _cell_weights(self, p, cell: str, dtype=None):
        """Node-conditioned weights of `cell` (a parameter prefix) per seed,
        split into (W_x, W_h) (S, N, K, I, O) plus bias (S, N, O).

        W[n,k,i,o] = node_emb[n,:] . pool[:,k,i,o], scaled by
        softmax(weights_g) over k when adjtype='multi'. With `dtype` the gate
        is folded into the small pool and the two halves are expanded from
        operands rounded to `dtype` and rounded to it (multi_atgcn.py:652-684).
        """
        h = self.hidden_dim
        emb = p["node_emb"]
        pool = p[cell + ".weights_pool"]
        bias = torch.bmm(emb, p[cell + ".bias_pool"])
        gate = None
        if self.adjtype == "multi":
            gate = torch.softmax(p[cell + ".weights_g"], dim=1)[:, None, :, 0, 0, None, None]  # (S,1,K,1,1)
        if dtype is None:
            w = _seed_project(emb, pool.flatten(2), 0).unflatten(2, pool.shape[2:])
            if gate is not None:
                w = w * gate
            dim_in = w.shape[3] - h
            return w[:, :, :, :dim_in], w[:, :, :, dim_in:], bias
        if gate is not None:
            pool = pool * gate
        pool = _round(pool, dtype)
        emb_r = _round(emb, dtype)
        dim_in = pool.shape[3] - h
        w_x = _seed_project(emb_r, pool[:, :, :, :dim_in].flatten(2), 0).unflatten(2, (-1, dim_in, pool.shape[4]))
        w_h = _seed_project(emb_r, pool[:, :, :, dim_in:].flatten(2), 0).unflatten(2, (-1, h, pool.shape[4]))
        w_x, w_h = w_x.to(dtype), w_h.to(dtype)
        return w_x, w_h, bias

    def _res_weights(self, p, layer: int, dim_in: int):
        """Residual GRU kernels per seed (S, in, out) split into x and h
        parts, plus biases (S, out)."""
        base = "encoder.res_cells.{}.".format(layer)
        rgk = p[base + "gate.weight"].transpose(1, 2)
        ruk = p[base + "update.weight"].transpose(1, 2)
        return (rgk[:, :dim_in], ruk[:, :dim_in], rgk[:, dim_in:], ruk[:, dim_in:],
                p[base + "gate.bias"], p[base + "update.bias"])

    def _encoder_q8(self, p, x, init_state, supports):
        """int8-weight-streamed N-major encoder; every per-step tensor is
        N-major (T, S, N, B, *), with one transpose at entry and one at exit."""
        dtype = self.compute_dtype
        h = self.hidden_dim
        weights_gru = torch.sigmoid(p["encoder.weights_gru"])  # (S, L, T)
        current = x.permute(2, 0, 3, 1, 4)  # (T, S, N, B, C)
        supports_r = _round(supports, dtype)
        for layer_idx in range(self.num_layers):
            cell = "encoder.agru_cells.{}.".format(layer_idx)
            state = init_state[layer_idx].permute(0, 2, 1, 3)  # (S, N, B, H)
            t_len, dim_in = current.shape[0], current.shape[-1]
            w_seq = weights_gru[:, layer_idx, :t_len].T  # (T, S)
            rg_xk, ru_xk, rg_h, ru_h, rg_b, ru_b = self._res_weights(p, layer_idx, dim_in)
            res_x = _seed_project(current, torch.cat([rg_xk, ru_xk], dim=2), 1)
            rg_x, ru_x = res_x[..., : 2 * h].to(dtype), res_x[..., 2 * h:].to(dtype)
            wg_x, wg_h, bg = self._cell_weights(p, cell + "gate", dtype)
            wu_x, wu_h, bu = self._cell_weights(p, cell + "update", dtype)
            hx = torch.einsum("sknm,tsmbc->tsnbkc", supports, current)
            xw = torch.einsum("tsnbki,snkio->tsnbo", _round(hx, dtype),
                              torch.cat([wg_x, wu_x], dim=4).float())
            gate_x, upd_x = xw[..., : 2 * h].to(dtype), xw[..., 2 * h:].to(dtype)
            if torch.is_grad_enabled():
                current = _FusedATGRULayerQ8.apply(dtype, gate_x, upd_x, rg_x, ru_x, w_seq, supports,
                                                   wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state)
                continue
            wq8 = _quantize_h_weights(wg_h, wu_h)
            rg_h_r, ru_h_r = _round(rg_h, dtype), _round(ru_h, dtype)
            states = []
            for t in range(t_len):
                state, _ = _atgru_step_q8(
                    state, (gate_x[t], upd_x[t], rg_x[t], ru_x[t], w_seq[t]), supports_r, wq8,
                    bg, bu, rg_h_r, ru_h_r, rg_b, ru_b, dtype)
                states.append(state)
            current = torch.stack(states)  # (T, S, N, B, H)
        return current.permute(1, 3, 0, 2, 4)  # (S, B, T, N, H)

    def _encoder(self, p, x, init_state, supports):
        """x: (S, B, T, N, C) -> per-step states of the last layer (S, B, T, N, H)."""
        if x.shape[3] != self.num_nodes:
            raise ValueError("node-dimension mismatch: {} vs {}".format(x.shape[3], self.num_nodes))
        if self.uses_int8_stream:
            return self._encoder_q8(p, x, init_state, supports)
        dtype = self.compute_dtype
        h = self.hidden_dim
        weights_gru = torch.sigmoid(p["encoder.weights_gru"])  # (S, L, T)
        current = x.permute(2, 0, 1, 3, 4)  # (T, S, B, N, C)
        for layer_idx in range(self.num_layers):
            state = init_state[layer_idx]  # (S, B, N, H)
            t_len, dim_in = current.shape[0], current.shape[-1]
            w_seq = weights_gru[:, layer_idx, :t_len].T  # (T, S)
            rg_xk, ru_xk, rg_h, ru_h, rg_b, ru_b = self._res_weights(p, layer_idx, dim_in)
            res_x = _seed_project(current, torch.cat([rg_xk, ru_xk], dim=2), 1)
            rg_x, ru_x = res_x[..., : 2 * h], res_x[..., 2 * h:]
            states = []
            if not self.gcn_off:
                cell = "encoder.agru_cells.{}.".format(layer_idx)
                wg_x, wg_h, bg = self._cell_weights(p, cell + "gate", dtype)
                wu_x, wu_h, bu = self._cell_weights(p, cell + "update", dtype)
                hx = torch.einsum("sknm,tsbmc->tsbknc", supports, current)
                w_x = torch.cat([wg_x, wu_x], dim=4)
                if dtype is not None:
                    hx, w_x = hx.to(dtype).float(), w_x.float()
                xw = torch.einsum("tsbkni,snkio->tsbno", hx, w_x)
                gate_x, upd_x = xw[..., : 2 * h], xw[..., 2 * h:]
                if dtype is not None:
                    gate_x, upd_x = gate_x.to(dtype), upd_x.to(dtype)
                    rg_x, ru_x = rg_x.to(dtype), ru_x.to(dtype)
                else:
                    # one dense copy of each strided per-step stack (kernel
                    # B3), the seeds and the batch as one axis of it
                    gate_x = layout_ops.force_default_layout(gate_x.flatten(1, 2)).unflatten(1, gate_x.shape[1:3])
                    upd_x = layout_ops.force_default_layout(upd_x.flatten(1, 2)).unflatten(1, upd_x.shape[1:3])
                if self.fused_bptt and torch.is_grad_enabled():
                    current = _FusedATGRULayer.apply(dtype, gate_x, upd_x, rg_x, ru_x, w_seq, supports,
                                                     wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, state)
                    continue
                # no autograd, or plain autograd of the step loop (fused_bptt off)
                for t in range(t_len):
                    state, _ = _atgru_step(
                        state, (gate_x[t], upd_x[t], rg_x[t], ru_x[t], w_seq[t]), supports,
                        wg_h, wu_h, bg, bu, rg_h, ru_h, rg_b, ru_b, dtype)
                    states.append(state)
            else:
                for t in range(t_len):  # plain GRU only (ref :187-192)
                    z_r = torch.sigmoid(rg_x[t] + _seed_mm(state, rg_h) + rg_b[:, None, None])
                    z, r = torch.chunk(z_r, 2, dim=-1)
                    hc = torch.tanh(ru_x[t] + _seed_mm(z * state, ru_h) + ru_b[:, None, None])
                    state = r * state + (1.0 - r) * hc
                    states.append(state)
            current = torch.stack(states)  # (T, S, B, N, H)
        return current.permute(1, 2, 0, 3, 4)

    def _dropout(self, states, train: bool, generator: Optional[torch.Generator]):
        """Inverted dropout at ``dropout_rate`` in train mode (flax
        nn.Dropout: keep with probability 1 - rate, scale by 1/(1 - rate))."""
        if not train or self.dropout_rate == 0.0:
            return states
        keep = torch.empty_like(states).bernoulli_(1.0 - self.dropout_rate, generator=generator)
        return states * keep / (1.0 - self.dropout_rate)

    # --------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` turns dropout on (rate ``dropout_rate``, keep mask drawn
        from ``generator``, which lies on x's device), as the JAX module's
        ``train`` flag does."""
        return self.forward_seeds(self.seed_parameters(), x[None], train, [generator])[0]

    def forward_seeds(self, params, x: torch.Tensor, train: bool = False, generators=None) -> torch.Tensor:
        """The forward of S models of this architecture at once, the
        counterpart of the JAX module's apply under ``jax.vmap``: `params`
        maps every parameter name to its S values stacked (S, *shape), x is
        (S, B, T, N, F) (each seed's own batch), ``generators`` the S dropout
        generators; returns (S, B, Tout, N, output_dim). The graph buffers
        are this module's, shared by the seeds."""
        p = dict(params)
        s = x.shape[0]
        if "node_emb" not in p:  # node_specific_off: the frozen buffer
            p["node_emb"] = self.node_emb.expand((s,) + self.node_emb.shape)
        source = x[..., self.start_dim: self.end_dim]
        # without the period/trend heads (Tout < 6) only closeness is read
        total_len = (self.len_closeness + self.len_period + self.len_trend
                     if self.output_window >= 6 else self.len_closeness)
        if source.shape[2] < total_len:
            raise ValueError("input has {} steps but the active temporal heads need {}".format(
                source.shape[2], total_len))

        # multi-head temporal fusion (ref :366-393)
        head_gate = torch.softmax(p["weight_tsg"], dim=1)
        batch = source.shape[1]
        fused = source.new_zeros((s, batch, HOURS_PER_BLOCK, self.num_nodes, self.output_dim))
        groups = [(0, self.len_closeness)]
        if self.output_window >= 6:
            groups += [(self.len_closeness, self.len_period),
                       (self.len_closeness + self.len_period, self.len_trend)]
        head = 0
        for begin, length in groups:
            for _ in range(length // HOURS_PER_BLOCK):
                block = source[:, :, begin: begin + HOURS_PER_BLOCK]
                gate = head_gate[:, head].reshape(s, 1, 1, 1, 1)
                fused = fused + gate * block * p["weight_ts.{}".format(head)]
                begin += HOURS_PER_BLOCK
                head += 1

        # re-append calendar and dynamic external features (ref :396-402)
        parts = [fused]
        if self.time_index_dim:
            parts.append(x[:, :, : self.input_window, :, self.end_dim: self.end_dim + self.time_index_dim])
        if self.load_dynamic:
            parts.append(x[:, :, : self.input_window, :, self.end_dim + self.time_index_dim:])
        enc_in = torch.cat(parts, dim=-1) if len(parts) > 1 else fused

        shape = (self.num_layers, s, batch, self.num_nodes, self.hidden_dim)
        if self.static_proj is not None:
            emb = torch.relu(torch.baddbmm(p["static_initial_gru.embd.bias"][:, None],
                                           self.static_proj.expand((s,) + self.static_proj.shape),
                                           p["static_initial_gru.embd.weight"].transpose(1, 2)))  # (S, N, H)
            init_state = emb[None, :, None].expand(shape)
        else:
            init_state = x.new_zeros(shape)

        states = self._encoder(p, enc_in, init_state, self._build_supports(p))  # (S, B, T, N, H)
        if self.fnn_off:
            states = states[:, :, -1:]
        if train and self.dropout_rate != 0.0:  # each seed's mask from its own generator
            states = torch.stack([self._dropout(states[i], True, g) for i, g in enumerate(generators)])

        # conv output head as a (T*H -> Tout*out) contraction (ref :340-344,416-418)
        _, b, t, n, h = states.shape
        flat = states.permute(0, 1, 3, 2, 4).reshape(s, b * n, t * h)
        weight = p["end_conv.weight"]
        kernel = weight.reshape(s, weight.shape[1], t * h)
        out = torch.baddbmm(p["end_conv.bias"][:, None], flat, kernel.transpose(1, 2))
        return out.reshape(s, b, n, self.output_window, self.output_dim).permute(0, 1, 3, 2, 4)


def build_multi_atgcn(config, data_feature, device=None,
                      generator: Optional[torch.Generator] = None) -> MultiATGCN:
    """Construct the module from config + data_feature (ref :221-354) on
    `device` (CUDA unless "cpu" is asked for), its weights drawn from
    `generator` (default: seeded with config['seed'])."""
    device = resolve_device(device)
    # load_dynamic couples dataset and model with opposite defaults (dataset
    # True, model False); fail here rather than in a shape error downstream
    load_dynamic = config.get("load_dynamic", False)
    ext_dim = data_feature.get("ext_dim", 1)
    add_tid = config.get("add_time_in_day", False)
    add_dow = config.get("add_day_in_week", False)
    time_index_dim = 8 if (add_tid and add_dow) else (1 if add_tid else (7 if add_dow else 0))
    if not load_dynamic and ext_dim > time_index_dim:
        raise ValueError(
            "Inconsistent load_dynamic: the dataset fused {} external feature "
            "column(s) into X (ext_dim={} > time_index_dim={}) but the model "
            "was built with load_dynamic=False, so its input width would not "
            "match. Set load_dynamic explicitly in the config: true to feed "
            "the .ext columns to the encoder, false to keep them out of the "
            "dataset as well (the dataset defaults load_dynamic to TRUE, the "
            "model to FALSE — reference quirk, traffic_state_datatset.py:35 "
            "vs MultiATGCN.py:312).".format(ext_dim - time_index_dim, ext_dim, time_index_dim))
    num_nodes = data_feature.get("num_nodes", 1)
    static = data_feature.get("static", None)
    adjtype = config.get("adjtype", "od")
    cheb_k = config.get("cheb_order", 2)
    embed_dim_node = config.get("embed_dim_node", 10)
    embed_dim_adj = config.get("embed_dim_adj", 10)

    base_adj, support_pairs = graph_views.build_views(
        data_feature.get("adj_mx", None), static, data_feature.get("coordinate", None),
        num_nodes, adjtype)
    supports_static = graph_views.stack_static_supports(support_pairs, cheb_k)
    static_proj = None
    if static is not None:
        static_proj = initializers.pca_project(static, min(num_nodes, embed_dim_node))

    model = MultiATGCN(
        num_nodes=num_nodes,
        input_window=config.get("input_window", 1),
        output_window=config.get("output_window", 1),
        start_dim=config.get("start_dim", 0),
        end_dim=config.get("end_dim", 1),
        ext_dim=ext_dim,
        hidden_dim=config.get("rnn_units", 64),
        num_layers=config.get("num_layers", 2),
        cheb_k=cheb_k,
        embed_dim_node=embed_dim_node,
        embed_dim_adj=embed_dim_adj,
        adjtype=adjtype,
        adpadj=config.get("adpadj", "bidirection"),
        add_time_in_day=add_tid,
        add_day_in_week=add_dow,
        load_dynamic=load_dynamic,
        gcn_off=config.get("gcn_off", False),
        fnn_off=config.get("fnn_off", False),
        node_specific_off=config.get("node_specific_off", False),
        len_closeness=data_feature.get("len_closeness", 0),
        len_period=data_feature.get("len_period", 0),
        len_trend=data_feature.get("len_trend", 0),
        supports_static=supports_static,
        static_proj=static_proj,
        fused_bptt=config.get("fused_bptt", True),
        weight_stream_quant=config.get("weight_stream_quant", None),
        compute_dtype=config.get("compute_dtype", None),
        device=device,
    )
    overrides = {}
    if config.get("svd_init", False):
        # the reference's (overwritten) SVD/PCA init recipe, opt-in
        overrides["node_vec1"], overrides["node_vec2"] = initializers.svd_lowrank_embeddings(
            base_adj, embed_dim_adj)
        if static is not None and not model.node_specific_off:
            overrides["node_emb"] = initializers.pca_project(static, min(num_nodes, embed_dim_node))
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
    model.init_parameters(generator, overrides)
    return model.eval()
