"""STSGCN, the spatial-temporal synchronous graph convolutional network.

Counterpart of multistgraph_tpu/models/stsgcn.py (Song et al., AAAI 2020),
on the zoo's shared API (models/zoo.py), the JAX parameter names. A
localized spatial-temporal graph over 3 consecutive steps
(``build_sync_adjacency``: the (3N, 3N) block matrix with A + I on the
diagonal blocks and I between the same node at adjacent steps,
row-normalised); an STSGCM runs a stack of GLU graph convs on it and
crops the middle N rows, the layers aggregated by an elementwise max; an
STSGCL adds learned spatial and temporal embeddings and slides the 3-step
window over time (T shrinks by 2), the window positions folded into the
batch. ``module_type`` "individual" (the paper's default) gives each
window position its own kernels, one stacked (T', C, 2H) tensor applied by
one position-batched einsum; "sharing" one kernel a layer. The input lift
is a dense layer; the head predicts each horizon from the remaining
(T', H) window.
"""

from typing import Optional

import numpy as np
import torch

from multistgraph_tpu_torch.models.zoo import ZooModule, finish
from multistgraph_tpu_torch.utils import resolve_device


def build_sync_adjacency(adj: np.ndarray, steps: int = 3) -> np.ndarray:
    """(steps*N, steps*N) localized ST graph: A + I on the diagonal blocks,
    I between the same node at adjacent steps, rows normalised."""
    n = len(adj)
    big = np.zeros((steps * n, steps * n), np.float32)
    eye = np.eye(n, dtype=np.float32)
    a = np.asarray(adj, np.float32) + eye
    for s in range(steps):
        big[s * n:(s + 1) * n, s * n:(s + 1) * n] = a
        if s + 1 < steps:
            big[s * n:(s + 1) * n, (s + 1) * n:(s + 2) * n] = eye
            big[(s + 1) * n:(s + 2) * n, s * n:(s + 1) * n] = eye
    deg = big.sum(axis=1, keepdims=True)
    return big / np.where(deg > 0, deg, 1.0)


class STSGCN(ZooModule):
    """Stacked spatial-temporal synchronous graph conv layers."""

    def __init__(self, sync_adj, num_nodes: int, input_window: int, output_window: int, output_dim: int,
                 input_dim: int = 1, hidden_dim: int = 64, gcn_depth: int = 3, num_layers: int = 2,
                 window: int = 3, module_type: str = "individual", device=None):
        super().__init__(output_dim, device)
        self.num_nodes = num_nodes
        self.output_window = output_window
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.gcn_depth = gcn_depth
        self.num_layers = num_layers
        self.window = window
        self.individual = module_type == "individual"
        self.constant("sync_adj", sync_adj)   # (window*N, window*N)
        self.param("lift_kernel", (input_dim, hidden_dim), "dense")
        self.param("lift_bias", (hidden_dim,), "zeros")
        t_cur = input_window
        for li in range(num_layers):
            t_out = t_cur - (window - 1)
            if t_out < 1:
                raise ValueError("input window too short for {} STSGCN layers".format(num_layers))
            self.param("l{}_spatial_emb".format(li), (1, 1, num_nodes, hidden_dim), "torch")
            self.param("l{}_temporal_emb".format(li), (1, t_cur, 1, hidden_dim), "torch")
            for d in range(gcn_depth):
                name = "l{}_g{}".format(li, d)
                if self.individual:
                    self.param(name + "_kernel", (t_out, hidden_dim, 2 * hidden_dim), "dense")
                    self.param(name + "_bias", (t_out, 1, 2 * hidden_dim), "zeros")
                else:
                    self.param(name + "_kernel", (hidden_dim, 2 * hidden_dim), "dense")
                    self.param(name + "_bias", (2 * hidden_dim,), "zeros")
            t_cur = t_out
        self.t_rem = t_cur
        self.param("head1_kernel", (t_cur * hidden_dim, output_window * hidden_dim), "dense")
        self.param("head1_bias", (output_window * hidden_dim,), "zeros")
        self.param("head2_kernel", (output_window, hidden_dim, output_dim), "torch")
        self.param("head2_bias", (output_window, output_dim), "zeros")

    def _stsgcm(self, name, xw, t_out):
        """The GLU graph-conv stack on (B*T', wN, C); the max over the
        layers' middle N rows: (B*T', N, H)."""
        a = self.sync_adj
        n, w, hid = self.num_nodes, self.window, self.hidden_dim
        mid = (w // 2) * n
        h = xw
        crops = []
        for d in range(self.gcn_depth):
            wk, wb = getattr(self, "{}_g{}_kernel".format(name, d)), getattr(self, "{}_g{}_bias".format(name, d))
            if self.individual:
                hg = torch.einsum("pq,btqc->btpc", a, h.reshape(-1, t_out, w * n, h.shape[-1]))
                z = (torch.einsum("btpc,tcd->btpd", hg, wk) + wb).reshape(-1, w * n, 2 * hid)
            else:
                z = torch.einsum("pq,bqc->bpc", a, h) @ wk + wb
            p, q = z.split(hid, dim=-1)
            h = p * torch.sigmoid(q)
            crops.append(h[:, mid: mid + n])
        return torch.amax(torch.stack(crops), dim=0)   # ties share the gradient, as JAX's max

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        w = self.window
        h = self.linear(x[..., : self.input_dim], "lift")   # (B, T, N, H)
        for li in range(self.num_layers):
            t_out = h.shape[1] - (w - 1)
            hp = h + getattr(self, "l{}_spatial_emb".format(li)) + getattr(self, "l{}_temporal_emb".format(li))
            wins = torch.stack([hp[:, j: j + t_out] for j in range(w)], dim=2)   # (B, T', w, N, C)
            out = self._stsgcm("l{}".format(li), wins.reshape(b * t_out, w * n, h.shape[-1]), t_out)
            h = out.reshape(b, t_out, n, self.hidden_dim)
        if h.shape[1] != self.t_rem:
            raise ValueError("built for {} steps after the layers, the input leaves {}".format(
                self.t_rem, h.shape[1]))
        flat = h.permute(0, 2, 1, 3).reshape(b, n, self.t_rem * self.hidden_dim)
        y = torch.relu(self.linear(flat, "head1")).reshape(b, n, self.output_window, self.hidden_dim)
        out = torch.einsum("bnoc,ocd->bnod", y, self.head2_kernel) + self.head2_bias[None, None]
        return out.permute(0, 2, 1, 3)


def build_stsgcn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> STSGCN:
    adj = np.asarray(data_feature.get("adj_mx"))
    model = STSGCN(
        sync_adj=build_sync_adjacency(adj, config.get("stsg_window", 3)),
        num_nodes=data_feature.get("num_nodes", 1),
        input_window=config.get("input_window", 12),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        gcn_depth=config.get("gcn_depth", 3),
        num_layers=config.get("num_layers", 2),
        window=config.get("stsg_window", 3),
        module_type=config.get("module_type", "individual"),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
