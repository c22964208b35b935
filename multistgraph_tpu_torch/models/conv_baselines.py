"""Convolutional spatio-temporal baselines: STGCN and GWNET (Graph WaveNet).

Counterpart of multistgraph_tpu/models/conv_baselines.py, on the zoo's
shared API (models/zoo.py), the JAX parameter names. Neither model has a
recurrence: every temporal convolution is a sum of shifted-slice matmuls
(``zoo.temporal_slices``), every graph conv an einsum over dense supports.
  * STGCN (Yu et al., IJCAI 2018): ST-Conv blocks of a gated temporal conv
    (GLU), a Chebyshev graph conv over the scaled Laplacian's polynomials,
    a second gated temporal conv and a LayerNorm (``b{i}_ln``); then a GLU
    over the remaining window, ``out_ln`` and a two-layer head;
  * GWNET (Wu et al., IJCAI 2019): dilated causal convs with tanh x
    sigmoid gates, skip sums, a diffusion graph conv over the forward and
    backward random walks plus the adaptive adjacency softmax(relu(E1 E2)),
    dropout (0.3 by default) in train mode; windows shorter than the
    receptive field are zero-padded at the front.

Dropout draws from the generator the caller passes (the executor's).
"""

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from multistgraph_tpu_torch.graph.laplacian import cheb_polynomials, random_walk_matrix, scaled_laplacian
from multistgraph_tpu_torch.models.zoo import ZooModule, dropout, finish, temporal_slices, to_horizons
from multistgraph_tpu_torch.utils import resolve_device


class STGCN(ZooModule):
    """Spatio-Temporal Graph Convolutional Network (Chebyshev variant)."""

    def __init__(self, supports, input_window: int, output_window: int, output_dim: int, input_dim: int = 1,
                 kt: int = 3, channels: Sequence[Sequence[int]] = ((64, 16, 64), (64, 16, 64)),
                 dropout: float = 0.0, device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.input_dim = input_dim
        self.kt = kt
        self.channels = tuple(tuple(c) for c in channels)
        self.dropout = dropout
        self.constant("supports", supports)   # (Ks, N, N)
        k = self.supports.shape[0]
        dim_in = input_dim
        for i, (c_t1, c_s, c_t2) in enumerate(self.channels):
            self._glu_params("b{}_t1".format(i), dim_in, c_t1)
            self.param("b{}_s_kernel".format(i), (k * c_t1, c_s), "dense")
            self.param("b{}_s_bias".format(i), (c_s,), "zeros")
            self._glu_params("b{}_t2".format(i), c_s, c_t2)
            self.layer_norm("b{}_ln".format(i), c_t2)
            dim_in = c_t2
        self.t_rem = input_window - 2 * len(self.channels) * (kt - 1)
        if self.t_rem < 1:
            raise ValueError("input window too short for {} ST-Conv blocks of kt={}".format(len(self.channels), kt))
        self.param("out_t_kernel", (self.t_rem, dim_in, 2 * dim_in), "torch")
        self.param("out_t_bias", (2 * dim_in,), "zeros")
        self.layer_norm("out_ln", dim_in)
        self.param("head1_kernel", (dim_in, dim_in), "dense")
        self.param("head1_bias", (dim_in,), "zeros")
        self.param("head2_kernel", (dim_in, output_window * output_dim), "dense")
        self.param("head2_bias", (output_window * output_dim,), "zeros")

    def _glu_params(self, name, dim_in, dim_out):
        self.param(name + "_kernel", (self.kt, dim_in, 2 * dim_out), "torch")
        self.param(name + "_bias", (2 * dim_out,), "zeros")

    def _temporal_glu(self, name, x, dim_out):
        """Gated temporal conv (P + res) * sigmoid(Q); trims kt - 1 steps."""
        dim_in = x.shape[-1]
        wk = getattr(self, name + "_kernel")
        y = sum(s @ wk[j] for j, s in enumerate(temporal_slices(x, self.kt))) + getattr(self, name + "_bias")
        p, q = y.split(dim_out, dim=-1)
        res = x[:, self.kt - 1:]
        if dim_in > dim_out:
            res = res[..., :dim_out]
        elif dim_in < dim_out:
            res = F.pad(res, (0, dim_out - dim_in))
        return (p + res) * torch.sigmoid(q)

    def _cheb_gconv(self, name, x, dim_out):
        """Chebyshev graph conv, a ReLU residual where the widths agree."""
        xg = torch.einsum("knm,btmc->btknc", self.supports, x)
        b, t, k, n, c = xg.shape
        y = self.linear(xg.transpose(2, 3).reshape(b, t, n, k * c), name)
        if c == dim_out:
            y = y + x
        return torch.relu(y)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        h = x[..., : self.input_dim]
        for i, (c_t1, c_s, c_t2) in enumerate(self.channels):
            h = self._temporal_glu("b{}_t1".format(i), h, c_t1)
            h = self._cheb_gconv("b{}_s".format(i), h, c_s)
            h = self._temporal_glu("b{}_t2".format(i), h, c_t2)
            h = getattr(self, "b{}_ln".format(i))(h)
            h = dropout(h, self.dropout, train, generator)
        if h.shape[1] != self.t_rem:
            raise ValueError("built for {} steps after the blocks, the input leaves {}".format(
                self.t_rem, h.shape[1]))
        dim = h.shape[-1]
        y = torch.einsum("btnc,tcd->bnd", h, self.out_t_kernel) + self.out_t_bias
        p, q = y.split(dim, dim=-1)
        y = self.out_ln((p + h[:, -1]) * torch.sigmoid(q))
        y = torch.relu(self.linear(y, "head1"))
        return to_horizons(self.linear(y, "head2"), b, n, self.output_window, self.output_dim)


class GWNET(ZooModule):
    """Graph WaveNet: a dilated gated TCN with a diffusion and adaptive graph conv."""

    def __init__(self, supports, num_nodes: int, output_window: int, output_dim: int, input_dim: int = 1,
                 residual_channels: int = 32, dilation_channels: int = 32, skip_channels: int = 256,
                 end_channels: int = 512, blocks: int = 4, layers: int = 2, kernel_size: int = 2,
                 diffusion_order: int = 2, adaptive: bool = True, embed_dim: int = 10, dropout: float = 0.3,
                 device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.input_dim = input_dim
        self.blocks = blocks
        self.layers = layers
        self.kernel_size = kernel_size
        self.diffusion_order = diffusion_order
        self.adaptive = adaptive
        self.dropout = dropout
        self.num_static = len(supports)
        for i, s in enumerate(supports):
            self.constant("support{}".format(i), s)
        if adaptive:
            self.param("adp_e1", (num_nodes, embed_dim), "torch")
            self.param("adp_e2", (embed_dim, num_nodes), "torch")
        self.param("start_kernel", (input_dim, residual_channels), "dense")
        self.param("start_bias", (residual_channels,), "zeros")
        num_supports = self.num_static + (1 if adaptive else 0)
        for bi in range(blocks):
            for li in range(layers):
                name = "b{}l{}".format(bi, li)
                self.param(name + "_filter", (kernel_size, residual_channels, dilation_channels), "torch")
                self.param(name + "_gate", (kernel_size, residual_channels, dilation_channels), "torch")
                self.param(name + "_skip_kernel", (dilation_channels, skip_channels), "dense")
                self.param(name + "_skip_bias", (skip_channels,), "zeros")
                width = dilation_channels * (1 + num_supports * diffusion_order)
                self.param(name + "_gconv_kernel", (width, residual_channels), "dense")
                self.param(name + "_gconv_bias", (residual_channels,), "zeros")
        self.param("end1_kernel", (skip_channels, end_channels), "dense")
        self.param("end1_bias", (end_channels,), "zeros")
        self.param("end2_kernel", (end_channels, output_window * output_dim), "dense")
        self.param("end2_bias", (output_window * output_dim,), "zeros")

    def _gconv(self, name, x, supports):
        """Diffusion conv: x and the powers 1..order of each support applied to it, concatenated."""
        outs = [x]
        for s in supports:
            xk = x
            for _ in range(self.diffusion_order):
                xk = torch.einsum("nm,btmc->btnc", s, xk)
                outs.append(xk)
        return self.linear(torch.cat(outs, dim=-1), name)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        h = x[..., : self.input_dim]
        receptive = 1 + (self.kernel_size - 1) * self.blocks * (2 ** self.layers - 1)
        if t < receptive:
            h = F.pad(h, (0, 0, 0, 0, receptive - t, 0))
        supports = [getattr(self, "support{}".format(i)) for i in range(self.num_static)]
        if self.adaptive:
            supports.append(torch.softmax(torch.relu(self.adp_e1 @ self.adp_e2), dim=1))
        h = self.linear(h, "start")
        skip_total = 0.0
        for bi in range(self.blocks):
            dilation = 1
            for li in range(self.layers):
                name = "b{}l{}".format(bi, li)
                slices = temporal_slices(h, self.kernel_size, dilation)
                fw, gw = getattr(self, name + "_filter"), getattr(self, name + "_gate")
                filt = torch.tanh(sum(s @ fw[j] for j, s in enumerate(slices)))
                gate = torch.sigmoid(sum(s @ gw[j] for j, s in enumerate(slices)))
                z = filt * gate   # (B, T', N, dilation_channels)
                skip_total = self.linear(z[:, -1], name + "_skip") + skip_total   # the last step only
                g = dropout(self._gconv(name + "_gconv", z, supports), self.dropout, train, generator)
                h = g + h[:, -g.shape[1]:]   # residual, trimmed to the causal length
                dilation *= 2
        y = torch.relu(self.linear(torch.relu(skip_total), "end1"))
        return to_horizons(self.linear(y, "end2"), b, n, self.output_window, self.output_dim)


def _cheb_supports(adj: np.ndarray, k: int) -> np.ndarray:
    """[T_0..T_{k-1}] of the scaled Laplacian 2L/lmax - I (STGCN's supports)."""
    sl = scaled_laplacian(adj, lambda_max=None, undirected=True)
    return np.stack(cheb_polynomials(sl, max(k, 1)))


def _random_walk_supports(adj: np.ndarray) -> list:
    """[D^-1 A, D'^-1 A^T], the forward and backward transition matrices (GWNET's)."""
    adj = np.asarray(adj, np.float64)
    return [random_walk_matrix(adj), random_walk_matrix(adj.T)]


def build_stgcn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> STGCN:
    model = STGCN(
        supports=_cheb_supports(np.asarray(data_feature.get("adj_mx")), config.get("Ks", 3)),
        input_window=config.get("input_window", 12),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("output_dim", 1),
        kt=config.get("Kt", 3),
        dropout=config.get("dropout", 0.0),
        device=resolve_device(device),
    )
    return finish(model, config, generator)


def build_gwnet(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> GWNET:
    model = GWNET(
        supports=_random_walk_supports(np.asarray(data_feature.get("adj_mx"))),
        num_nodes=data_feature.get("num_nodes", 1),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("output_dim", 1),
        residual_channels=config.get("residual_channels", 32),
        dilation_channels=config.get("dilation_channels", 32),
        skip_channels=config.get("skip_channels", 256),
        end_channels=config.get("end_channels", 512),
        blocks=config.get("blocks", 4),
        layers=config.get("layers", 2),
        diffusion_order=config.get("diffusion_order", 2),
        adaptive=config.get("adpadj", "adaptive") != "none",
        embed_dim=config.get("embed_dim_adj", 10),
        dropout=config.get("dropout", 0.3),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
