"""Baseline forecasters: RNN (plain, GRU, LSTM cells), FNN and Seq2Seq.

Counterpart of multistgraph_tpu/models/baselines.py, on the zoo's shared
API (models/zoo.py): input (B, Tin, N, F) -> (B, Tout, N, output_dim), the
parameters shared across nodes (each node is a batch row of the recurrent
core), the JAX parameter names. The time recurrence is a Python loop over
the window where JAX scans. Trained on TrafficStatePointDataset.
"""

from typing import Optional

import torch

from multistgraph_tpu_torch.models.zoo import ZooModule, finish, to_horizons
from multistgraph_tpu_torch.utils import resolve_device

_GATES = {"LSTM": 4, "GRU": 3}


def gru_step(hidden: torch.Tensor, x_t: torch.Tensor, wk: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """One GRU step on [x_t, hidden] with the (in + h, 3h) kernel: the
    first 2h columns give z and r, the last h the candidate."""
    h = hidden.shape[-1]
    zr = torch.sigmoid(torch.cat([x_t, hidden], dim=-1) @ wk[:, : 2 * h] + wb[: 2 * h])
    z, r = zr.split(h, dim=-1)
    cand = torch.cat([x_t, r * hidden], dim=-1) @ wk[:, 2 * h:] + wb[2 * h:]
    return (1 - z) * hidden + z * torch.tanh(cand)


class RNNModel(ZooModule):
    """Stacked plain RNN, GRU or LSTM over time, the nodes folded into the
    batch; the last hidden state projected to every horizon at once."""

    def __init__(self, output_window: int, output_dim: int, input_dim: int, hidden_dim: int = 64,
                 num_layers: int = 1, rnn_type: str = "GRU", device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.kind = rnn_type.upper()
        gates = _GATES.get(self.kind, 1)
        for layer in range(num_layers):
            dim_in = input_dim if layer == 0 else hidden_dim
            self.param("l{}_kernel".format(layer), (dim_in + hidden_dim, gates * hidden_dim), "dense")
            self.param("l{}_bias".format(layer), (gates * hidden_dim,), "zeros")
        self.param("head_kernel", (hidden_dim, output_window * output_dim), "dense")
        self.param("head_bias", (output_window * output_dim,), "uniform05")

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, f = x.shape
        h = self.hidden_dim
        seq = x.permute(1, 0, 2, 3).reshape(t, b * n, f)
        for layer in range(self.num_layers):
            wk, wb = getattr(self, "l{}_kernel".format(layer)), getattr(self, "l{}_bias".format(layer))
            hidden = x.new_zeros((b * n, h))
            cell = x.new_zeros((b * n, h))
            outs = []
            for x_t in seq:
                if self.kind == "LSTM":
                    i, f_, g, o = (torch.cat([x_t, hidden], dim=-1) @ wk + wb).split(h, dim=-1)
                    cell = torch.sigmoid(f_ + 1.0) * cell + torch.sigmoid(i) * torch.tanh(g)
                    hidden = torch.sigmoid(o) * torch.tanh(cell)
                elif self.kind == "GRU":
                    hidden = gru_step(hidden, x_t, wk, wb)
                else:
                    hidden = torch.tanh(torch.cat([x_t, hidden], dim=-1) @ wk + wb)
                outs.append(hidden)
            seq = torch.stack(outs)
        return to_horizons(self.linear(seq[-1], "head"), b, n, self.output_window, self.output_dim)


class FNN(ZooModule):
    """Per-node MLP over the flattened input window."""

    def __init__(self, output_window: int, output_dim: int, input_window: int, input_dim: int,
                 hidden_dim: int = 64, num_layers: int = 2, device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.num_layers = num_layers
        dim_in = input_window * input_dim
        for layer in range(num_layers):
            self.param("l{}_kernel".format(layer), (dim_in, hidden_dim), "dense")
            self.param("l{}_bias".format(layer), (hidden_dim,), "uniform05")
            dim_in = hidden_dim
        self.param("head_kernel", (dim_in, output_window * output_dim), "dense")
        self.param("head_bias", (output_window * output_dim,), "uniform05")

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, f = x.shape
        h = x.permute(0, 2, 1, 3).reshape(b, n, t * f)
        for layer in range(self.num_layers):
            h = torch.relu(self.linear(h, "l{}".format(layer)))
        return to_horizons(self.linear(h, "head"), b, n, self.output_window, self.output_dim)


class Seq2Seq(ZooModule):
    """GRU encoder-decoder; the decoder rolls out Tout steps
    autoregressively from the last input step's first output_dim channels."""

    def __init__(self, output_window: int, output_dim: int, input_dim: int, hidden_dim: int = 64, device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.hidden_dim = hidden_dim
        for name, dim_in in (("encoder", input_dim), ("decoder", output_dim)):
            self.param(name + "_kernel", (dim_in + hidden_dim, 3 * hidden_dim), "dense")
            self.param(name + "_bias", (3 * hidden_dim,), "zeros")
        self.param("proj_kernel", (hidden_dim, output_dim), "dense")
        self.param("proj_bias", (output_dim,), "uniform05")

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, f = x.shape
        seq = x.permute(1, 0, 2, 3).reshape(t, b * n, f)
        hidden = x.new_zeros((b * n, self.hidden_dim))
        for x_t in seq:
            hidden = gru_step(hidden, x_t, self.encoder_kernel, self.encoder_bias)
        y = seq[-1][:, : self.output_dim]
        ys = []
        for _ in range(self.output_window):
            hidden = gru_step(hidden, y, self.decoder_kernel, self.decoder_bias)
            y = self.linear(hidden, "proj")
            ys.append(y)
        return torch.stack(ys).reshape(self.output_window, b, n, self.output_dim).permute(1, 0, 2, 3)


def _common(config, data_feature):
    return dict(output_window=config.get("output_window", 1), output_dim=data_feature.get("output_dim", 1),
                hidden_dim=config.get("rnn_units", 64))


def build_rnn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> RNNModel:
    """RNN, GRU or LSTM by config['rnn_type'] (the parser sets it from an
    LSTM or GRU model name)."""
    model = RNNModel(input_dim=data_feature.get("feature_dim", 1), num_layers=config.get("num_layers", 1),
                     rnn_type=config.get("rnn_type", "GRU"), device=resolve_device(device),
                     **_common(config, data_feature))
    return finish(model, config, generator)


def build_fnn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> FNN:
    model = FNN(input_window=config.get("input_window", 1), input_dim=data_feature.get("feature_dim", 1),
                num_layers=config.get("num_layers", 2), device=resolve_device(device),
                **_common(config, data_feature))
    return finish(model, config, generator)


def build_seq2seq(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> Seq2Seq:
    model = Seq2Seq(input_dim=data_feature.get("feature_dim", 1), device=resolve_device(device),
                    **_common(config, data_feature))
    return finish(model, config, generator)
