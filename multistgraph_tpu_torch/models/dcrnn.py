"""DCRNN, the Diffusion Convolutional Recurrent Neural Network.

Counterpart of multistgraph_tpu/models/dcrnn.py (Li et al., ICLR 2018), on
the zoo's shared API (models/zoo.py), the JAX parameter names: an
encoder-decoder of stacked DCGRU cells, GRUs whose transforms are diffusion
convolutions (the input and the powers 1..K of each transition matrix
applied to [x, h], concatenated, times one kernel). The decoder rolls the
horizon out autoregressively from a zero GO symbol.

Scheduled sampling (the paper's curriculum) runs only in train mode, when
the model has ``cl_decay_steps > 0`` and the caller passes the targets and
the teacher-forcing ratio: the decoder's input at step t is then the truth
of step t - 1 with probability ``tf_ratio`` (step 0 keeps the GO symbol),
one coin per (horizon step, sample), drawn from the caller's generator as
uniform < ratio (``sampling_coins``), as JAX draws ``bernoulli``. The
executor computes the ratio from its global step into a device scalar,
which a replayed step reads (executor/executor.py). Inference is purely
autoregressive. The coins are not JAX's bits: the same rate, other draws.
"""

from typing import Optional

import numpy as np
import torch

from multistgraph_tpu_torch.graph.laplacian import supports_by_filter_type
from multistgraph_tpu_torch.models.zoo import ZooModule, finish
from multistgraph_tpu_torch.utils import resolve_device


def sampling_coins(tf_ratio, output_window: int, batch: int, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """(Tout, B, 1, 1) booleans, each true with probability `tf_ratio` (a
    float or a 0-d tensor on `device`): uniform draws from `generator`
    below the ratio."""
    u = torch.rand((output_window, batch, 1, 1), generator=generator, device=device)
    return u < tf_ratio


class DCRNN(ZooModule):
    """Diffusion-convolutional GRU encoder-decoder."""

    def __init__(self, supports, output_window: int, output_dim: int, input_dim: int = 1, hidden_dim: int = 64,
                 num_layers: int = 2, max_diffusion_step: int = 2, cl_decay_steps: int = 0, device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.max_diffusion_step = max_diffusion_step
        # > 0 enables scheduled sampling; the executor computes the decaying
        # teacher-forcing ratio from it and the global step
        self.cl_decay_steps = cl_decay_steps
        self.constant("supports", supports)   # (S, N, N)
        width = self.supports.shape[0] * max_diffusion_step + 1
        for layer in range(num_layers):
            for prefix, dim_in in (("e", input_dim if layer == 0 else hidden_dim),
                                   ("d", output_dim if layer == 0 else hidden_dim)):
                for cell, dim_out in (("gate", 2 * hidden_dim), ("cand", hidden_dim)):
                    name = "{}{}_{}".format(prefix, layer, cell)
                    self.param(name + "_kernel", (width * (dim_in + hidden_dim), dim_out), "dense")
                    self.param(name + "_bias", (dim_out,), "zeros")
        self.param("proj_kernel", (hidden_dim, output_dim), "dense")
        self.param("proj_bias", (output_dim,), "zeros")

    def _dconv(self, z: torch.Tensor, name: str) -> torch.Tensor:
        outs = [z]
        for s in self.supports:
            zk = z
            for _ in range(self.max_diffusion_step):
                zk = torch.einsum("nm,bmc->bnc", s, zk)
                outs.append(zk)
        return self.linear(torch.cat(outs, dim=-1), name)

    def _cell(self, name: str, state: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """One DCGRU step: (state (B, N, H), inp (B, N, dim_in)) -> state."""
        r, u = torch.sigmoid(self._dconv(torch.cat([inp, state], dim=-1), name + "_gate")).split(
            self.hidden_dim, dim=-1)
        c = torch.tanh(self._dconv(torch.cat([inp, r * state], dim=-1), name + "_cand"))
        return u * state + (1.0 - u) * c

    def _stack(self, prefix: str, states, inp):
        new = []
        for layer in range(self.num_layers):
            inp = self._cell("{}{}".format(prefix, layer), states[layer], inp)
            new.append(inp)
        return new, inp

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None,
                targets: Optional[torch.Tensor] = None, tf_ratio=None) -> torch.Tensor:
        b, t, n, _f = x.shape
        states = [x.new_zeros((b, n, self.hidden_dim)) for _ in range(self.num_layers)]
        for inp in x[..., : self.input_dim].permute(1, 0, 2, 3):
            states, _ = self._stack("e", states, inp)

        go = x.new_zeros((b, n, self.output_dim))
        prev_true = coins = None
        if train and targets is not None and tf_ratio is not None and self.cl_decay_steps > 0:
            # the step-t input is the truth of step t - 1 with probability
            # tf_ratio; step 0's "truth" is the GO symbol, so its coin does nothing
            tgt = targets[..., : self.output_dim].to(x.dtype)
            prev_true = torch.cat([go[:, None], tgt[:, :-1]], dim=1).permute(1, 0, 2, 3)
            coins = sampling_coins(tf_ratio, self.output_window, b, generator, x.device)
        y, ys = go, []
        for step in range(self.output_window):
            inp = y if coins is None else torch.where(coins[step], prev_true[step], y)
            states, top = self._stack("d", states, inp)
            y = self.linear(top, "proj")
            ys.append(y)
        return torch.stack(ys, dim=1)   # (B, Tout, N, D)


def build_dcrnn(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> DCRNN:
    sups = supports_by_filter_type(np.asarray(data_feature.get("adj_mx")),
                                   config.get("filter_type", "dual_random_walk"))
    model = DCRNN(
        supports=np.stack([np.asarray(s, np.float32) for s in sups]),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        num_layers=config.get("num_rnn_layers", config.get("num_layers", 2)),
        max_diffusion_step=config.get("max_diffusion_step", 2),
        cl_decay_steps=config.get("cl_decay_steps", 0),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
