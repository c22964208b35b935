"""Parameter initializers with the reference's effective init scheme.

Counterpart of multistgraph_tpu/models/initializers.py. The reference
overwrites every parameter with xavier_uniform (dim>1) / U[0,1) (vectors)
after its SVD/PCA setup (MultiATGCN.py:348,356-361), so that is the default;
the SVD/PCA recipes stay available behind ``svd_init``. Draws come from an
explicit CPU ``torch.Generator``, so a seed gives the same weights on every
device. (They are not the JAX package's numbers: the tests carry weights
across with utils/jax_import.py.)
"""

import math
from typing import Tuple

import numpy as np
import torch


def _torch_fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """torch.nn.init._calculate_fan_in_and_fan_out: fan_in = shape[1]*rf, fan_out = shape[0]*rf."""
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def torch_style_init(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """xavier_uniform (torch fan rules, gain 1) for dim>1; U[0,1) for dim<=1. CPU float32."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    if len(shape) > 1:
        fan_in, fan_out = _torch_fans(shape)
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return u * (2 * bound) - bound
    return u


def dense_kernel_init(shape_in_out: Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """A Linear weight (out, in) for a (in, out) dense kernel: xavier with
    fan_in=in, fan_out=out, as the JAX package's dense_kernel_init draws it."""
    fan_in, fan_out = shape_in_out
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.rand((fan_out, fan_in), generator=generator, dtype=torch.float32) * (2 * bound) - bound


def svd_lowrank_embeddings(adj: np.ndarray, rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """E1 = U sqrt(S), E2 = sqrt(S) V^T of the base adjacency (MultiATGCN.py:298-304)."""
    u, s, vt = np.linalg.svd(np.asarray(adj, dtype=np.float64), full_matrices=False)
    root = np.sqrt(s[:rank])
    return (u[:, :rank] * root[None, :]).astype(np.float32), (root[:, None] * vt[:rank, :]).astype(np.float32)


def pca_project(static: np.ndarray, q: int) -> np.ndarray:
    """Project static features onto their top-q principal directions (centered
    numpy SVD, the same arithmetic as the JAX package: a build-time constant)."""
    static = np.asarray(static, dtype=np.float64)
    centered = static - static.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return (static @ vt[:q].T).astype(np.float32)
