"""STTN, the spatial-temporal transformer network.

Counterpart of multistgraph_tpu/models/sttn.py (Xu et al., 2020), on the
zoo's shared API (models/zoo.py), the JAX parameter names. Each block is a
spatial transformer, then a temporal one:
  * spatial: multi-head self-attention over the nodes at each step,
    gate-fused with a fixed two-hop graph conv over the symmetric-normalised
    adjacency (``graph_baselines._sym_norm_adj``), residual + LayerNorm and
    a position-wise FFN under a second LayerNorm;
  * temporal: multi-head self-attention over the steps of each node, with
    a learned position embedding, residual + LayerNorm and an FFN;
dropout (0 by default) after each block in train mode. The head collapses
each node's (T, C) window to every horizon at once.
"""

from typing import Optional

import numpy as np
import torch

from multistgraph_tpu_torch.models.graph_baselines import _sym_norm_adj
from multistgraph_tpu_torch.models.zoo import ZooModule, attend, dropout, finish, to_horizons
from multistgraph_tpu_torch.utils import resolve_device


class STTN(ZooModule):
    """Stacked spatial and temporal transformer blocks."""

    def __init__(self, adj_norm, input_window: int, output_window: int, output_dim: int, input_dim: int = 1,
                 hidden_dim: int = 64, num_heads: int = 4, num_blocks: int = 2, ffn_dim: int = 128,
                 dropout: float = 0.0, device=None):
        super().__init__(output_dim, device)
        self.input_window = input_window
        self.output_window = output_window
        self.input_dim = input_dim
        self.num_heads = num_heads
        self.num_blocks = num_blocks
        self.dropout = dropout
        c = hidden_dim
        self.constant("adj_norm", adj_norm)
        self.param("lift_kernel", (input_dim, c), "dense")
        self.param("lift_bias", (c,), "zeros")
        for blk in range(num_blocks):
            name = "b{}".format(blk)
            self._mha_params(name + "_sat", c)
            self.param(name + "_gc1", (c, c), "dense")
            self.param(name + "_gc2", (c, c), "dense")
            self.param(name + "_gate_kernel", (2 * c, c), "dense")
            self.param(name + "_gate_bias", (c,), "zeros")
            self.layer_norm(name + "_sln1", c)
            self._ffn_params(name + "_sffn", c, ffn_dim)
            self.layer_norm(name + "_sln2", c)
            self.param(name + "_pos_emb", (1, input_window, 1, c), "torch")
            self._mha_params(name + "_tat", c)
            self.layer_norm(name + "_tln1", c)
            self._ffn_params(name + "_tffn", c, ffn_dim)
            self.layer_norm(name + "_tln2", c)
        self.param("head_kernel", (input_window, c, output_window * output_dim), "torch")
        self.param("head_bias", (output_window * output_dim,), "zeros")

    def _mha_params(self, name, c):
        for part in ("q", "k", "v", "o"):
            self.param("{}_{}_kernel".format(name, part), (c, c), "dense")

    def _ffn_params(self, name, c, ffn_dim):
        self.param(name + "_w1", (c, ffn_dim), "dense")
        self.param(name + "_b1", (ffn_dim,), "zeros")
        self.param(name + "_w2", (ffn_dim, c), "dense")
        self.param(name + "_b2", (c,), "zeros")

    def _mha(self, name, x, over):
        q, k, v, o = (getattr(self, "{}_{}_kernel".format(name, part)) for part in ("q", "k", "v", "o"))
        return attend(x @ q, x @ k, x @ v, self.num_heads, over) @ o

    def _ffn(self, name, x):
        w1, b1, w2, b2 = (getattr(self, name + s) for s in ("_w1", "_b1", "_w2", "_b2"))
        return torch.relu(x @ w1 + b1) @ w2 + b2

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        if t != self.input_window:
            raise ValueError("built for {} input steps, the input has {}".format(self.input_window, t))
        a = self.adj_norm
        h = self.linear(x[..., : self.input_dim], "lift")
        for blk in range(self.num_blocks):
            name = "b{}".format(blk)
            att = self._mha(name + "_sat", h, "n")
            gcn = torch.einsum("nm,btmc->btnc", a, torch.relu(
                torch.einsum("nm,btmc->btnc", a, h) @ getattr(self, name + "_gc1"))) @ getattr(self, name + "_gc2")
            gate = torch.sigmoid(self.linear(torch.cat([att, gcn], dim=-1), name + "_gate"))
            s_out = gate * att + (1.0 - gate) * gcn
            h = getattr(self, name + "_sln1")(h + s_out)
            h = getattr(self, name + "_sln2")(h + self._ffn(name + "_sffn", h))
            t_out = self._mha(name + "_tat", h + getattr(self, name + "_pos_emb"), "t")
            h = getattr(self, name + "_tln1")(h + t_out)
            h = getattr(self, name + "_tln2")(h + self._ffn(name + "_tffn", h))
            h = dropout(h, self.dropout, train, generator)
        out = torch.einsum("btnc,tcd->bnd", h, self.head_kernel) + self.head_bias
        return to_horizons(out, b, n, self.output_window, self.output_dim)


def build_sttn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> STTN:
    model = STTN(
        adj_norm=_sym_norm_adj(np.asarray(data_feature.get("adj_mx"))),
        input_window=config.get("input_window", 12),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        num_heads=config.get("num_heads", 4),
        num_blocks=config.get("num_blocks", 2),
        ffn_dim=config.get("ffn_dim", 128),
        dropout=config.get("dropout", 0.0),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
