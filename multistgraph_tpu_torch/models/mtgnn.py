"""MTGNN, the multivariate time-series GNN with graph learning.

Counterpart of multistgraph_tpu/models/mtgnn.py (Wu et al., KDD 2020), on
the zoo's shared API (models/zoo.py), the JAX parameter names:
  * the graph learning layer: node embeddings E1, E2, M_i = tanh(alpha E_i W_i),
    A = relu(tanh(alpha (M1 M2^T - M2 M1^T))) kept to each row's top k
    (``learned_adjacency``; ties with the k-th value are kept, and the
    gradient flows through the kept entries only);
  * per layer: a dilated inception conv (kernels 2/3/6/7, the channels
    split across them, shifted-slice sums aligned to the largest kernel)
    gated tanh x sigmoid, dropout (0.3 by default) in train mode, a skip
    that collapses the remaining window, and a mix-hop propagation
    (h_i = beta x + (1 - beta) A_hat h_{i-1}, hops concatenated then mixed)
    over A and A^T summed; residual + LayerNorm (``l{i}_ln``);
  * the head: relu(skip sum), then two dense layers to every horizon.
A window shorter than the receptive field is zero-padded at the front.
``gcn_off`` replaces the mix-hop by one dense layer (no learned graph).
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from multistgraph_tpu_torch.models.zoo import ZooModule, dropout, finish, temporal_slices, to_horizons
from multistgraph_tpu_torch.utils import resolve_device


def learned_adjacency(e1, e2, w1, w2, alpha: float, k: int) -> torch.Tensor:
    """A = relu(tanh(alpha (M1 M2^T - M2 M1^T))), each row kept to its
    entries at or above the row's k-th largest."""
    m1 = torch.tanh(alpha * (e1 @ w1))
    m2 = torch.tanh(alpha * (e2 @ w2))
    a = torch.relu(torch.tanh(alpha * (m1 @ m2.t() - m2 @ m1.t())))
    kth = torch.topk(a, k, dim=1).values[:, -1:]
    return torch.where(a >= kth, a, torch.zeros_like(a))


class MTGNN(ZooModule):
    """Graph learning and a dilated-inception TCN."""

    def __init__(self, num_nodes: int, input_window: int, output_window: int, output_dim: int,
                 input_dim: int = 1, embed_dim: int = 40, subgraph_size: int = 20, conv_channels: int = 32,
                 residual_channels: int = 32, skip_channels: int = 64, end_channels: int = 128,
                 layers: int = 3, kernel_set: Sequence[int] = (2, 3, 6, 7), dilation_exponential: int = 1,
                 gdep: int = 2, alpha: float = 3.0, propalpha: float = 0.05, dropout: float = 0.3,
                 use_gcn: bool = True, device=None):
        super().__init__(output_dim, device)
        self.num_nodes = num_nodes
        self.output_window = output_window
        self.input_dim = input_dim
        self.subgraph_size = subgraph_size
        self.conv_channels = conv_channels
        self.residual_channels = residual_channels
        self.layers = layers
        self.kernel_set = tuple(kernel_set)
        self.dilation_exponential = dilation_exponential
        self.gdep = gdep
        self.alpha = alpha
        self.propalpha = propalpha
        self.dropout = dropout
        self.use_gcn = use_gcn
        spans = [(max(self.kernel_set) - 1) * dilation_exponential ** i for i in range(layers)]
        self.receptive = 1 + sum(spans)
        t = max(input_window, self.receptive)   # the window after the front padding
        if use_gcn:
            self.param("gl_e1", (num_nodes, embed_dim), "torch")
            self.param("gl_e2", (num_nodes, embed_dim), "torch")
            self.param("gl_w1", (embed_dim, embed_dim), "dense")
            self.param("gl_w2", (embed_dim, embed_dim), "dense")
        self.param("start_kernel", (input_dim, residual_channels), "dense")
        self.param("start_bias", (residual_channels,), "zeros")
        self._collapse_params("skip0", t, residual_channels, skip_channels)
        c_each = conv_channels // len(self.kernel_set)
        for li, span in enumerate(spans):
            name = "l{}".format(li)
            for part in ("_f", "_g"):
                for kt in self.kernel_set:
                    self.param("{}{}_k{}".format(name, part, kt), (kt, residual_channels, c_each), "torch")
            t -= span
            self._collapse_params(name + "_skip", t, conv_channels, skip_channels)
            if use_gcn:
                for mh in ("_mh1", "_mh2"):
                    self.param(name + mh + "_kernel", ((gdep + 1) * conv_channels, residual_channels), "dense")
                    self.param(name + mh + "_bias", (residual_channels,), "zeros")
            else:
                self.param(name + "_nogcn_kernel", (conv_channels, residual_channels), "dense")
            self.layer_norm(name + "_ln", residual_channels)
        self._collapse_params("skipE", t, residual_channels, skip_channels)
        self.param("end1_kernel", (skip_channels, end_channels), "dense")
        self.param("end1_bias", (end_channels,), "zeros")
        self.param("end2_kernel", (end_channels, output_window * output_dim), "dense")
        self.param("end2_bias", (output_window * output_dim,), "zeros")

    def _collapse_params(self, name, t, c, c_out):
        self.param(name + "_kernel", (t, c, c_out), "torch")
        self.param(name + "_bias", (c_out,), "zeros")

    def _collapse(self, name, x):
        """Dense over the remaining window: (B, T', N, C) -> (B, N, c_out)."""
        return torch.einsum("btnc,tcd->bnd", x, getattr(self, name + "_kernel")) + getattr(self, name + "_bias")

    def _inception(self, name, x, dilation):
        """The dilated inception conv: each kernel's causal conv, trimmed to
        the largest kernel's output length, concatenated over channels."""
        max_span = (max(self.kernel_set) - 1) * dilation
        outs = []
        for kt in self.kernel_set:
            wk = getattr(self, "{}_k{}".format(name, kt))
            y = sum(s @ wk[j] for j, s in enumerate(temporal_slices(x, kt, dilation)))
            outs.append(y[:, max_span - (kt - 1) * dilation:])
        return torch.cat(outs, dim=-1)

    def _mixhop(self, name, x, adj):
        """h_i = beta x + (1 - beta) A_hat h_{i-1} over A_hat = row-normalised
        A + I; the hops concatenated and mixed by one dense layer."""
        a = adj + torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
        a = a / a.sum(dim=1, keepdim=True)
        hops = [x]
        h = x
        for _ in range(self.gdep):
            h = self.propalpha * x + (1.0 - self.propalpha) * torch.einsum("nm,btmc->btnc", a, h)
            hops.append(h)
        return self.linear(torch.cat(hops, dim=-1), name)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        if n != self.num_nodes:
            raise ValueError("graph built for {} nodes, input has {}".format(self.num_nodes, n))
        h = x[..., : self.input_dim]
        if t < self.receptive:
            h = F.pad(h, (0, 0, 0, 0, self.receptive - t, 0))
        adj = None
        if self.use_gcn:
            adj = learned_adjacency(self.gl_e1, self.gl_e2, self.gl_w1, self.gl_w2, self.alpha,
                                    min(self.subgraph_size, n))
        h = self.linear(h, "start")
        skip = self._collapse("skip0", h)
        dilation = 1
        for li in range(self.layers):
            name = "l{}".format(li)
            residual = h
            z = torch.tanh(self._inception(name + "_f", h, dilation)) * torch.sigmoid(
                self._inception(name + "_g", h, dilation))
            z = dropout(z, self.dropout, train, generator)
            skip = skip + self._collapse(name + "_skip", z)
            if self.use_gcn:
                g = self._mixhop(name + "_mh1", z, adj) + self._mixhop(name + "_mh2", z, adj.t())
            else:
                g = z @ getattr(self, name + "_nogcn_kernel")
            h = getattr(self, name + "_ln")(g + residual[:, -g.shape[1]:])
            dilation *= self.dilation_exponential
        skip = skip + self._collapse("skipE", h)
        y = torch.relu(self.linear(torch.relu(skip), "end1"))
        return to_horizons(self.linear(y, "end2"), b, n, self.output_window, self.output_dim)


def build_mtgnn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> MTGNN:
    num_nodes = data_feature.get("num_nodes", 1)
    model = MTGNN(
        num_nodes=num_nodes,
        input_window=config.get("input_window", 12),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        embed_dim=min(config.get("embed_dim_node", 40), num_nodes),
        subgraph_size=min(config.get("subgraph_size", 20), num_nodes),
        conv_channels=config.get("conv_channels", 32),
        residual_channels=config.get("residual_channels", 32),
        skip_channels=config.get("skip_channels", 64),
        end_channels=config.get("end_channels", 128),
        layers=config.get("layers", 3),
        dilation_exponential=config.get("dilation_exponential", 1),
        gdep=config.get("gcn_depth", 2),
        alpha=config.get("tanhalpha", 3.0),
        propalpha=config.get("propalpha", 0.05),
        dropout=config.get("dropout", 0.3),
        use_gcn=not config.get("gcn_off", False),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
