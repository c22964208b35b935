"""What the model zoo's families share: parameters under the JAX names,
their initialisers, dropout, the time-shifted views of the conv models and
the attention models' multi-head attention.

The zoo's families (models/baselines.py, graph_baselines.py,
conv_baselines.py, dcrnn.py, astgcn.py, mtgnn.py, stsgcn.py, sttn.py,
gman.py, stgode.py, stgncde.py) have no reference torch model, so
each keeps the JAX package's flat parameter names and shapes: a kernel
stays (in, out), a pool (e, K, in, out). A flax ``LayerNorm`` submodule
``b0_ln`` is an ``nn.LayerNorm`` named ``b0_ln`` here (its ``scale`` and
``bias`` are ``b0_ln.weight`` and ``b0_ln.bias``, utils/jax_import.py), at
flax's epsilon 1e-6.

Each parameter is drawn as the JAX package draws it, from an explicit CPU
``torch.Generator``: the same distributions, not the same numbers (a
"dense" kernel of more than two axes takes JAX's bound from its first two).

Every family's forward is plain torch ops of static shapes that neither
read the device back nor branch on data (MTGNN's top-k, STGNCDE's
checkpointed steps included), and its random draws (dropout, DCRNN's
coins) come from the generator the caller passes: on the card the
executor and the service record its steps as CUDA graphs (``graph_safe``,
executor/graphs.py).
"""

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from multistgraph_tpu_torch.models.initializers import dense_kernel_init, torch_style_init

LAYER_NORM_EPS = 1e-6   # flax.linen.LayerNorm's default


def _draw(init: str, shape, generator: torch.Generator) -> torch.Tensor:
    if init == "torch":
        return torch_style_init(shape, generator)
    if init == "dense" and len(shape) > 2:   # the JAX rule on more axes: the bound of (shape[0], shape[1])
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.rand(shape, generator=generator, dtype=torch.float32) * (2 * bound) - bound
    if init == "dense":     # a flax Dense kernel (in, out)
        return dense_kernel_init(shape, generator).t().contiguous()
    if init == "uniform05":  # the JAX heads' bias, U[-0.05, 0.05)
        return torch.rand(shape, generator=generator, dtype=torch.float32) * 0.1 - 0.05
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32)
    raise ValueError("unknown initialiser {!r}".format(init))


class ZooModule(nn.Module):
    """Base of the zoo's families: parameters registered with their
    initialiser, graph constants as buffers, the target channels
    ``start_dim:end_dim`` (0 to ``output_dim``)."""

    # read by the executor and the service: they record its steps as CUDA graphs
    graph_safe = True
    # read by utils/jax_import.py: the parameters carry the JAX names
    jax_names = True

    def __init__(self, output_dim: int, device=None):
        super().__init__()
        self.output_dim = output_dim
        self._device = device
        self._inits = {}

    @property
    def start_dim(self) -> int:
        return 0

    @property
    def end_dim(self) -> int:
        return self.output_dim

    def param(self, name: str, shape, init: str) -> None:
        self.register_parameter(name, nn.Parameter(torch.empty(tuple(shape), device=self._device)))
        self._inits[name] = init

    def layer_norm(self, name: str, width: int) -> None:
        self.add_module(name, nn.LayerNorm(width, eps=LAYER_NORM_EPS, device=self._device))

    def constant(self, name: str, array) -> None:
        """A graph constant (an adjacency, a support stack): a buffer out of
        the state dict, rebuilt from the dataset as the JAX module's
        attribute is."""
        t = torch.as_tensor(np.ascontiguousarray(np.asarray(array, np.float32)), device=self._device)
        self.register_buffer(name, t, persistent=False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Draw every registered parameter, in registration order; the
        LayerNorms keep ones and zeros."""
        for name, init in self._inits.items():
            p = getattr(self, name)
            p.copy_(_draw(init, tuple(p.shape), generator).to(p.device))

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """x @ <name>_kernel + <name>_bias."""
        return x @ getattr(self, name + "_kernel") + getattr(self, name + "_bias")


def dropout(x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax Dropout: in train mode keep each element with probability
    1 - rate (the mask drawn from `generator`, on x's device) and scale the
    kept ones by 1 / (1 - rate); else x."""
    if not train or rate <= 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def temporal_slices(x: torch.Tensor, kt: int, dilation: int = 1) -> List[torch.Tensor]:
    """The kt time-shifted views of x (B, T, N, C), each (B, T', N, C):
    element j is x[:, j*d : T-(kt-1-j)*d], so the sum of slice_j @ W_j is a
    causal temporal convolution with kernel kt and dilation d whose output
    t covers the input window [t, t + (kt-1)*d] (JAX conv_baselines.py:58-67)."""
    t = x.shape[1]
    span = (kt - 1) * dilation
    return [x[:, j * dilation: t - (span - j * dilation)] for j in range(kt)]


def attend(q, k, v, num_heads: int, over: str) -> torch.Tensor:
    """Multi-head attention of q (B, Tq, N, C) on k, v (B, Tk, N, C), over
    the nodes ('n', Tq = Tk) or the steps ('t'): (B, Tq, N, C)."""
    b, tq, n, c = q.shape
    tk = k.shape[1]
    dh = c // num_heads
    q = q.reshape(b, tq, n, num_heads, dh)
    k = k.reshape(b, tk, n, num_heads, dh)
    v = v.reshape(b, tk, n, num_heads, dh)
    if over == "n":
        att = torch.softmax(torch.einsum("btnhd,btmhd->bthnm", q, k) / math.sqrt(dh), dim=-1)
        out = torch.einsum("bthnm,btmhd->btnhd", att, v)
    else:
        att = torch.softmax(torch.einsum("btnhd,bsnhd->bnhts", q, k) / math.sqrt(dh), dim=-1)
        out = torch.einsum("bnhts,bsnhd->btnhd", att, v)
    return out.reshape(b, tq, n, c)


def to_horizons(out: torch.Tensor, b: int, n: int, output_window: int, output_dim: int) -> torch.Tensor:
    """(B, N, Tout*D) -> (B, Tout, N, D)."""
    return out.reshape(b, n, output_window, output_dim).permute(0, 2, 1, 3)


def finish(model: ZooModule, config, generator: Optional[torch.Generator]) -> ZooModule:
    """Draw the model's weights from `generator` (default: seeded with
    config['seed']); the model in eval mode, as every builder returns it."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
    model.init_parameters(generator)
    return model.eval()
