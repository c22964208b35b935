"""GMAN, the graph multi-attention network.

Counterpart of multistgraph_tpu/models/gman.py (Zheng et al., AAAI 2020),
on the zoo's shared API (models/zoo.py), the JAX parameter names: an
encoder of ST-attention blocks, a transform attention from the input
horizons to the output ones (queries from the future's spatio-temporal
embedding, keys from the past's), a decoder of blocks, and a two-layer
head. Each block runs attention over the nodes and over the steps, both
conditioned on the spatio-temporal embedding (STE), and merges them by a
learned gate.

The STE adds a spatial embedding, built on the host from the graph, to a
temporal one:
  * spatial: the first non-trivial eigenvectors of the symmetric-normalised
    Laplacian (``laplacian_positional_embedding``, numpy's f64 ``eigh``, so
    the eigenvectors' signs and order are the JAX package's), or the
    paper's node2vec (``gman_se='node2vec'``, graph/node2vec.py, the same
    numpy draws);
  * temporal: sin and cos of the time-of-day channel when the dataset adds
    it (``add_time_in_day``), the future steps extrapolated by
    ``time_intervals`` and wrapped into [0, 1); else a learned embedding of
    each position.
"""

import math
from typing import Optional

import numpy as np
import torch

from multistgraph_tpu_torch.graph.laplacian import normalized_laplacian
from multistgraph_tpu_torch.models.zoo import ZooModule, attend, finish
from multistgraph_tpu_torch.utils import resolve_device


def laplacian_positional_embedding(adj: np.ndarray, dim: int) -> np.ndarray:
    """The first `dim` non-trivial eigenvectors of the symmetric-normalised
    Laplacian of the undirected graph, zero-padded to `dim` columns."""
    lap = normalized_laplacian(np.maximum(adj, adj.T))
    _, vecs = np.linalg.eigh((lap + lap.T) / 2.0)
    emb = vecs[:, 1: dim + 1]
    if emb.shape[1] < dim:
        emb = np.pad(emb, [(0, 0), (0, dim - emb.shape[1])])
    return emb.astype(np.float32)


class GMAN(ZooModule):
    """Graph multi-attention encoder and decoder."""

    def __init__(self, spatial_emb, input_window: int, output_window: int, output_dim: int, input_dim: int = 1,
                 num_heads: int = 4, head_dim: int = 8, num_blocks: int = 1, time_index: Optional[int] = None,
                 time_delta: float = 1.0 / 24.0, device=None):
        super().__init__(output_dim, device)
        self.input_window = input_window
        self.output_window = output_window
        self.input_dim = input_dim
        self.num_heads = num_heads
        self.num_blocks = num_blocks
        # the time of day's channel, where the input has it
        self.time_index = time_index if time_index is not None and time_index < input_dim else None
        self.time_delta = time_delta
        d = self.model_dim = num_heads * head_dim
        self.constant("spatial_emb", spatial_emb)   # (N, se_dim)
        self._fc2_params("se", self.spatial_emb.shape[1], d)
        if self.time_index is not None:
            self._fc2_params("te", 2, d)
        else:
            self.param("te_pos", (1, input_window + output_window, 1, d), "torch")
        self._fc2_params("lift", input_dim, d)
        for i in range(num_blocks):
            self._block_params("enc{}".format(i))
        self._attention_params("trans", d)
        for i in range(num_blocks):
            self._block_params("dec{}".format(i))
        self.param("head_w1", (d, d), "dense")
        self.param("head_b1", (d,), "zeros")
        self.param("head_w2", (d, output_dim), "dense")
        self.param("head_b2", (output_dim,), "zeros")

    def _fc2_params(self, name, c, dim_out):
        self.param(name + "_w1", (c, dim_out), "dense")
        self.param(name + "_b1", (dim_out,), "zeros")
        self.param(name + "_w2", (dim_out, dim_out), "dense")
        self.param(name + "_b2", (dim_out,), "zeros")

    def _attention_params(self, name, c_qk):
        """Queries and keys from c_qk channels, values from the model's d."""
        d = self.model_dim
        self.param(name + "_q", (c_qk, d), "dense")
        self.param(name + "_k", (c_qk, d), "dense")
        self.param(name + "_v", (d, d), "dense")
        self.param(name + "_o", (d, d), "dense")

    def _block_params(self, name):
        d = self.model_dim
        self._attention_params(name + "_sp", 2 * d)
        self._attention_params(name + "_tm", 2 * d)
        self.param(name + "_z1", (d, d), "dense")
        self.param(name + "_z2", (d, d), "dense")
        self.param(name + "_zb", (d,), "zeros")
        self._fc2_params(name + "_out", d, d)

    def _fc2(self, name, x):
        w1, b1, w2, b2 = (getattr(self, name + s) for s in ("_w1", "_b1", "_w2", "_b2"))
        return torch.relu(x @ w1 + b1) @ w2 + b2

    def _ste(self, x, t_in):
        """The spatio-temporal embedding of Tin + Tout steps: (B, Tin+Tout, N, D)."""
        b = x.shape[0]
        se = self._fc2("se", self.spatial_emb)   # (N, D)
        if self.time_index is not None:
            tod = x[:, :, 0, self.time_index]   # (B, Tin), the fraction of the day
            steps = torch.arange(1, self.output_window + 1, dtype=x.dtype, device=x.device)[None]
            future = tod[:, -1:] + self.time_delta * steps
            tod_all = torch.cat([tod, torch.remainder(future, 1.0)], dim=1)
            turns = 2 * math.pi * tod_all
            te = self._fc2("te", torch.stack([torch.sin(turns), torch.cos(turns)], dim=-1))[:, :, None, :]
        else:
            te = self.te_pos.expand(b, t_in + self.output_window, 1, self.model_dim)
        return se[None, None] + te

    def _attention(self, name, q_in, k_in, v_in, over):
        q, k, v, o = (getattr(self, name + part) for part in ("_q", "_k", "_v", "_o"))
        return attend(q_in @ q, k_in @ k, v_in @ v, self.num_heads, over) @ o

    def _st_block(self, name, h, ste):
        """Attention over the nodes and over the steps, fused by a gate."""
        hs = torch.cat([h, ste], dim=-1)
        h_spatial = self._attention(name + "_sp", hs, hs, h, "n")
        h_temporal = self._attention(name + "_tm", hs, hs, h, "t")
        z = torch.sigmoid(h_spatial @ getattr(self, name + "_z1") + h_temporal @ getattr(self, name + "_z2")
                          + getattr(self, name + "_zb"))
        fused = z * h_spatial + (1.0 - z) * h_temporal
        return h + self._fc2(name + "_out", fused)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        t = x.shape[1]
        if t != self.input_window:
            raise ValueError("built for {} input steps, the input has {}".format(self.input_window, t))
        ste = self._ste(x, t)
        ste_past, ste_future = ste[:, :t], ste[:, t:]
        h = self._fc2("lift", x[..., : self.input_dim])
        for i in range(self.num_blocks):
            h = self._st_block("enc{}".format(i), h, ste_past)
        h = self._attention("trans", ste_future, ste_past, h, "t")
        for i in range(self.num_blocks):
            h = self._st_block("dec{}".format(i), h, ste_future)
        return torch.relu(h @ self.head_w1 + self.head_b1) @ self.head_w2 + self.head_b2   # (B, Tout, N, D)


def build_gman(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> GMAN:
    adj = np.asarray(data_feature.get("adj_mx"))
    se_dim = min(config.get("se_dim", 16), max(len(adj) - 1, 1))
    output_dim = data_feature.get("output_dim", 1)
    if config.get("gman_se", "laplacian") == "node2vec":
        from multistgraph_tpu_torch.graph.node2vec import node2vec_embedding

        spatial_emb = node2vec_embedding(
            adj, se_dim, num_walks=config.get("n2v_walks", 10), walk_length=config.get("n2v_length", 80),
            window=config.get("n2v_window", 10), p=config.get("n2v_p", 1.0), q=config.get("n2v_q", 1.0),
            seed=config.get("seed", 0) or 0)
    else:
        spatial_emb = laplacian_positional_embedding(adj, se_dim)
    model = GMAN(
        spatial_emb=spatial_emb,
        input_window=config.get("input_window", 12),
        output_window=config.get("output_window", 1),
        output_dim=output_dim,
        input_dim=data_feature.get("feature_dim", 1),
        num_heads=config.get("num_heads", 4),
        head_dim=config.get("head_dim", 8),
        num_blocks=config.get("num_blocks", 1),
        # the time of day sits right after the target channels when it is added
        time_index=output_dim if config.get("add_time_in_day", False) else None,
        time_delta=config.get("time_intervals", 3600) / 86400.0,
        device=resolve_device(device),
    )
    return finish(model, config, generator)
