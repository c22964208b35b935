"""ASTGCN, the Attention-based Spatial-Temporal GCN, and MSTGCN.

Counterpart of multistgraph_tpu/models/astgcn.py (Guo et al., AAAI 2019),
on the zoo's shared API (models/zoo.py), the JAX parameter names: the
single-component (recent-only) form, whose blocks are temporal attention
(T x T softmax) reweighting the time axis, spatial attention (N x N
softmax) modulating every Chebyshev support, the Chebyshev graph conv and
a ReLU, a 3-tap temporal conv (same padding), and a 1x1 residual under a
LayerNorm (``b{i}_ln``); a head collapses (T, nb_filter) per node to every
horizon. MSTGCN is the ``use_attention=False`` form (no attention
parameters). The supports are the scaled Laplacian's Chebyshev
polynomials (lambda_max from the eigenvalues, the graph made undirected).
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from multistgraph_tpu_torch.graph.laplacian import cheb_polynomials, scaled_laplacian
from multistgraph_tpu_torch.models.zoo import ZooModule, finish, to_horizons
from multistgraph_tpu_torch.utils import resolve_device


class ASTGCN(ZooModule):
    """Attention-based spatial-temporal GCN (recent-component form)."""

    def __init__(self, supports, num_nodes: int, input_window: int, output_window: int, output_dim: int,
                 input_dim: int = 1, nb_block: int = 2, nb_filter: int = 64, temporal_kernel: int = 3,
                 use_attention: bool = True, device=None):
        super().__init__(output_dim, device)
        self.input_window = input_window
        self.output_window = output_window
        self.input_dim = input_dim
        self.nb_block = nb_block
        self.nb_filter = nb_filter
        self.temporal_kernel = temporal_kernel
        self.use_attention = use_attention
        self.constant("supports", supports)   # (K, N, N)
        k = self.supports.shape[0]
        t, n = input_window, num_nodes
        for blk in range(nb_block):
            name = "b{}".format(blk)
            c_in = input_dim if blk == 0 else nb_filter
            if use_attention:
                for pname, shape in (("_tat_u1", (n,)), ("_tat_u2", (c_in, n)), ("_tat_u3", (c_in,)),
                                     ("_tat_be", (t, t)), ("_tat_ve", (t, t)),
                                     ("_sat_w1", (t,)), ("_sat_w2", (c_in, t)), ("_sat_w3", (c_in,)),
                                     ("_sat_bs", (n, n)), ("_sat_vs", (n, n))):
                    self.param(name + pname, shape, "torch")
            self.param(name + "_cheb_kernel", (k * c_in, nb_filter), "dense")
            self.param(name + "_cheb_bias", (nb_filter,), "zeros")
            self.param(name + "_tconv_kernel", (temporal_kernel, nb_filter, nb_filter), "torch")
            self.param(name + "_tconv_bias", (nb_filter,), "zeros")
            self.param(name + "_res_kernel", (c_in, nb_filter), "dense")
            self.layer_norm(name + "_ln", nb_filter)
        self.param("head_kernel", (t, nb_filter, output_window * output_dim), "torch")
        self.param("head_bias", (output_window * output_dim,), "zeros")

    def _temporal_attention(self, name, x):
        """E (B, T, T), a softmax over the last axis (the paper's eq. 6-7)."""
        u1, u2, u3, be, ve = (getattr(self, name + s) for s in ("_u1", "_u2", "_u3", "_be", "_ve"))
        lhs = torch.einsum("btnc,n,cm->btm", x, u1, u2)   # (B, T, N)
        rhs = torch.einsum("c,bsnc->bns", u3, x)          # (B, N, T)
        return torch.softmax(ve @ torch.sigmoid(lhs @ rhs + be), dim=-1)

    def _spatial_attention(self, name, x):
        """S (B, N, N), a softmax over the last axis (the paper's eq. 4-5)."""
        w1, w2, w3, bs, vs = (getattr(self, name + s) for s in ("_w1", "_w2", "_w3", "_bs", "_vs"))
        lhs = torch.einsum("btnc,t,cs->bns", x, w1, w2)   # (B, N, T)
        rhs = torch.einsum("c,btmc->btm", w3, x)          # (B, T, N)
        return torch.softmax(vs @ torch.sigmoid(lhs @ rhs + bs), dim=-1)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        if t != self.input_window:
            raise ValueError("built for a window of {} steps, the input has {}".format(self.input_window, t))
        h = x[..., : self.input_dim]
        k = self.supports.shape[0]
        pad = self.temporal_kernel // 2
        for blk in range(self.nb_block):
            name = "b{}".format(blk)
            c_in = h.shape[-1]
            if self.use_attention:
                h_t = torch.einsum("bts,bsnc->btnc", self._temporal_attention(name + "_tat", h), h)
                s = self._spatial_attention(name + "_sat", h_t)
                # the attention-modulated supports: T_k times S elementwise, per sample
                xg = torch.einsum("knm,bnm,btmc->btknc", self.supports, s, h_t)
            else:
                xg = torch.einsum("knm,btmc->btknc", self.supports, h)
            g = torch.relu(self.linear(xg.transpose(2, 3).reshape(b, t, n, k * c_in), name + "_cheb"))
            # the temporal conv, kernel 3, same padding
            gp = F.pad(g, (0, 0, 0, 0, pad, self.temporal_kernel - 1 - pad))
            tk, tb = getattr(self, name + "_tconv_kernel"), getattr(self, name + "_tconv_bias")
            tc = sum(gp[:, j: j + t] @ tk[j] for j in range(self.temporal_kernel)) + tb
            h = getattr(self, name + "_ln")(torch.relu(h @ getattr(self, name + "_res_kernel") + tc))
        out = torch.einsum("btnc,tcd->bnd", h, self.head_kernel) + self.head_bias
        return to_horizons(out, b, n, self.output_window, self.output_dim)


def _build_astgcn_like(use_attention: bool):
    def builder(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> ASTGCN:
        adj = np.asarray(data_feature.get("adj_mx"))
        sl = scaled_laplacian(adj, lambda_max=None, undirected=True)
        model = ASTGCN(
            supports=np.stack(cheb_polynomials(sl, max(config.get("cheb_order", 3), 1))),
            num_nodes=data_feature.get("num_nodes", adj.shape[0]),
            input_window=config.get("input_window", 12),
            output_window=config.get("output_window", 1),
            output_dim=data_feature.get("output_dim", 1),
            input_dim=data_feature.get("feature_dim", 1),
            nb_block=config.get("nb_block", 2),
            nb_filter=config.get("nb_filter", 64),
            use_attention=use_attention,
            device=resolve_device(device),
        )
        return finish(model, config, generator)

    return builder


build_astgcn = _build_astgcn_like(True)
build_mstgcn = _build_astgcn_like(False)
