"""Graph-convolutional recurrent baselines: AGCRN and TGCN.

Counterpart of multistgraph_tpu/models/graph_baselines.py, on the zoo's
shared API (models/zoo.py), the JAX parameter names:
  * AGCRN (Bai et al., NeurIPS 2020): the adaptive graph
    softmax(relu(E E^T)) of learned node embeddings, the Chebyshev stack
    [I, A, 2A T_{k-1} - T_{k-2}, ...], node-conditioned weight pools
    W[n] = E[n] @ pool, a GRU whose gate and candidate transforms are that
    graph conv, the last hidden state projected to every horizon;
  * TGCN (Zhao et al., T-ITS 2019): the symmetric-normalised predefined
    graph D^-1/2 (A+I) D^-1/2, a two-hop graph conv shared across nodes
    feeding GRU gates, the last hidden state projected.

The supports and AGCRN's per-node weights are built once a forward (JAX
builds them inside its scan's step, where XLA hoists them), and the time
loop is a Python loop. Every contraction is a torch einsum or matmul: no
path of either package runs a Pallas kernel here.
"""

from typing import Optional

import numpy as np
import torch

from multistgraph_tpu_torch.models.zoo import ZooModule, finish, to_horizons
from multistgraph_tpu_torch.utils import resolve_device


class AGCRN(ZooModule):
    """Adaptive Graph Convolutional Recurrent Network."""

    def __init__(self, num_nodes: int, output_window: int, output_dim: int, input_dim: int,
                 hidden_dim: int = 64, embed_dim: int = 10, cheb_k: int = 2, num_layers: int = 2, device=None):
        super().__init__(output_dim, device)
        self.num_nodes = num_nodes
        self.output_window = output_window
        self.hidden_dim = hidden_dim
        self.cheb_k = cheb_k
        self.num_layers = num_layers
        self.param("node_emb", (num_nodes, embed_dim), "torch")
        for layer in range(num_layers):
            dim_in = input_dim if layer == 0 else hidden_dim
            for cell, dim_out in (("gate", 2 * hidden_dim), ("cand", hidden_dim)):
                name = "l{}_{}".format(layer, cell)
                self.param(name + "_pool", (embed_dim, cheb_k, dim_in + hidden_dim, dim_out), "torch")
                self.param(name + "_bias_pool", (embed_dim, dim_out), "torch")
        self.param("head_kernel", (hidden_dim, output_window * output_dim), "dense")
        self.param("head_bias", (output_window * output_dim,), "uniform05")

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        if n != self.num_nodes:
            raise ValueError("graph built for {} nodes, input has {}".format(self.num_nodes, n))
        h = self.hidden_dim
        emb = self.node_emb
        adapt = torch.softmax(torch.relu(emb @ emb.t()), dim=1)
        sups = [torch.eye(n, dtype=x.dtype, device=x.device), adapt]
        for _ in range(2, self.cheb_k):
            sups.append(2.0 * adapt @ sups[-1] - sups[-2])
        supports = torch.stack(sups[: max(self.cheb_k, 1)])   # (K, N, N)

        def gconv(state, inp, w, bias):
            """The node-conditioned graph conv of [inp, state]: (B, N, dim_out)."""
            zg = torch.einsum("knm,bmc->bknc", supports, torch.cat([inp, state], dim=-1))
            return torch.einsum("bkni,nkio->bno", zg, w) + bias

        seq = x.permute(1, 0, 2, 3)   # (T, B, N, F)
        for layer in range(self.num_layers):
            cells = []
            for cell in ("gate", "cand"):
                name = "l{}_{}".format(layer, cell)
                cells.append((torch.einsum("nd,dkio->nkio", emb, getattr(self, name + "_pool")),
                              emb @ getattr(self, name + "_bias_pool")))
            (gate_w, gate_b), (cand_w, cand_b) = cells
            state = x.new_zeros((b, n, h))
            outs = []
            for inp in seq:
                z, r = torch.sigmoid(gconv(state, inp, gate_w, gate_b)).split(h, dim=-1)
                hc = torch.tanh(gconv(r * state, inp, cand_w, cand_b))
                state = z * state + (1.0 - z) * hc
                outs.append(state)
            seq = torch.stack(outs)
        return to_horizons(self.linear(seq[-1], "head"), b, n, self.output_window, self.output_dim)


class TGCN(ZooModule):
    """Temporal Graph Convolutional Network over a predefined graph."""

    def __init__(self, adj_norm, output_window: int, output_dim: int, input_dim: int, hidden_dim: int = 64,
                 device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.hidden_dim = hidden_dim
        self.constant("adj_norm", adj_norm)
        for name, dim_out in (("gate", 2 * hidden_dim), ("cand", hidden_dim)):
            self.param(name + "_w1", (input_dim + hidden_dim, dim_out), "dense")
            self.param(name + "_w2", (dim_out, dim_out), "dense")
            self.param(name + "_b", (dim_out,), "uniform05")
        self.param("head_kernel", (hidden_dim, output_window * output_dim), "dense")
        self.param("head_bias", (output_window * output_dim,), "uniform05")

    def _gc(self, name: str, z: torch.Tensor) -> torch.Tensor:
        """Two-hop propagation A (A z W1) W2 + b, shared across nodes."""
        a = self.adj_norm
        y = torch.einsum("nm,bmc->bnc", a, z) @ getattr(self, name + "_w1")
        return torch.einsum("nm,bmc->bnc", a, y) @ getattr(self, name + "_w2") + getattr(self, name + "_b")

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        h = self.hidden_dim
        state = x.new_zeros((b, n, h))
        for inp in x.permute(1, 0, 2, 3):
            z, r = torch.sigmoid(self._gc("gate", torch.cat([inp, state], dim=-1))).split(h, dim=-1)
            hc = torch.tanh(self._gc("cand", torch.cat([inp, r * state], dim=-1)))
            state = z * state + (1.0 - z) * hc
        return to_horizons(self.linear(state, "head"), b, n, self.output_window, self.output_dim)


def _sym_norm_adj(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 with zero-degree guards."""
    a = np.asarray(adj, np.float64) + np.eye(len(adj))
    d = a.sum(axis=1)
    d_inv = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))
    return (a * d_inv[:, None] * d_inv[None, :]).astype(np.float32)


def build_agcrn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> AGCRN:
    model = AGCRN(
        num_nodes=data_feature.get("num_nodes", 1),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        embed_dim=config.get("embed_dim_node", 10),
        cheb_k=config.get("cheb_order", 2),
        num_layers=config.get("num_layers", 2),
        device=resolve_device(device),
    )
    return finish(model, config, generator)


def build_tgcn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> TGCN:
    model = TGCN(
        adj_norm=_sym_norm_adj(np.asarray(data_feature.get("adj_mx"))),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
