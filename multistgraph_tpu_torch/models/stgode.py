"""STGODE, the spatial-temporal graph ODE network.

Counterpart of multistgraph_tpu/models/stgode.py (Fang et al., KDD 2021),
on the zoo's shared API (models/zoo.py), the JAX parameter names. Two
graph views, the spatial adjacency and a semantic graph from the DTW
distances between the nodes' mean daily profiles, each run by
``num_blocks`` parallel blocks (a gated temporal conv, a graph ODE, a
gated temporal conv, all on the same lifted input); the 2 x num_blocks
outputs meet in an elementwise max, and a two-layer head maps each node's
remaining (T', C) window to the horizons.

The graph ODE is dH/dt = alpha (A H - H) + H0 from H(0) = H0 over [0, 1],
alpha = sigmoid of a learned vector. Its default solver is the exact
solution in the eigenbasis of the static symmetric support: numpy's f64
``eigh`` on the host at construction (the JAX package's eigenvectors), then
per channel (e^z + phi1(z)) in eigencoordinates with z = alpha (lam - 1),
phi1 by ``expm1`` with the guard at |z| < 1e-12; two (N, N) products a
block. ``stgode_solver='rk4'``, and any asymmetric support, take the
fixed-step RK4 integrator (``ode_steps`` steps).

The host helpers are numpy copies of the JAX package's:
``dtw_profile_distances`` is its numpy dynamic program (the JAX package
runs a C++ one where it can build it, documented as the identical f32 DP),
``semantic_adjacency_from_dtw`` its Gaussian kernel cut at the
``stgode_sparsity`` quantile, ``_sym_norm_with_self_loops`` its
normalisation.
"""

from typing import Optional

import numpy as np
import torch

from multistgraph_tpu_torch.models.zoo import ZooModule, finish, temporal_slices, to_horizons
from multistgraph_tpu_torch.utils import resolve_device


def dtw_profile_distances(profiles: np.ndarray, band: int = 4) -> np.ndarray:
    """All-pairs DTW distance of the nodes' profiles (N, P) under the
    Sakoe-Chiba band |t - s| <= band: (N, N), symmetric, zero diagonal.
    One (N, N) relaxation a cell; the cost tensor is (N, N, P, P) f32."""
    profiles = np.asarray(profiles, np.float32)
    n, p = profiles.shape
    cost = np.abs(profiles[:, None, :, None] - profiles[None, :, None, :])
    inf = np.float32(np.inf)
    dp = np.full((n, n, p, p), inf, np.float32)
    for t in range(p):
        lo, hi = max(0, t - band), min(p, t + band + 1)
        for s in range(lo, hi):
            c = cost[:, :, t, s]
            if t == 0 and s == 0:
                dp[:, :, t, s] = c
                continue
            best = np.full((n, n), inf, np.float32)
            if t > 0:
                best = np.minimum(best, dp[:, :, t - 1, s])
            if s > 0:
                best = np.minimum(best, dp[:, :, t, s - 1])
            if t > 0 and s > 0:
                best = np.minimum(best, dp[:, :, t - 1, s - 1])
            dp[:, :, t, s] = c + best
    d = dp[:, :, p - 1, p - 1]
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def semantic_adjacency_from_dtw(dist: np.ndarray, sparsity: float = 0.1) -> np.ndarray:
    """The Gaussian kernel of the DTW distances, kept at or above its
    (1 - sparsity) quantile off the diagonal."""
    d = np.asarray(dist, np.float64)
    off = d[~np.eye(len(d), dtype=bool)]
    sigma = off.std() + 1e-8
    a = np.exp(-((d / sigma) ** 2))
    np.fill_diagonal(a, 0.0)
    if off.size:
        thresh = np.quantile(a[~np.eye(len(a), dtype=bool)], 1.0 - sparsity)
        a = np.where(a >= thresh, a, 0.0)
    return a.astype(np.float32)


def _sym_norm_with_self_loops(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2: spectral radius <= 1, so the linear ODE is
    non-expansive and fixed-step RK4 over [0, 1] is stable."""
    a = np.asarray(adj, np.float32) + np.eye(len(adj), dtype=np.float32)
    deg = a.sum(axis=1)
    d = 1.0 / np.sqrt(np.where(deg > 0, deg, 1.0))
    return (a * d[:, None]) * d[None, :]


class STGODE(ZooModule):
    """Parallel TCN-ODE-TCN blocks over the spatial and semantic views."""

    def __init__(self, supports, input_window: int, output_window: int, output_dim: int, input_dim: int = 1,
                 hidden_dim: int = 64, kt: int = 3, num_blocks: int = 3, ode_steps: int = 6,
                 head_dim: int = 128, ode_solver: str = "spectral", device=None):
        super().__init__(output_dim, device)
        self.output_window = output_window
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.kt = kt
        self.num_blocks = num_blocks
        self.ode_steps = ode_steps
        t_rem = input_window - 2 * (kt - 1)
        if t_rem < 1:
            raise ValueError("input window too short for a TCN-ODE-TCN block of kt={}".format(kt))
        self.t_rem = t_rem
        sup = np.asarray(supports, np.float32)
        self.num_views = sup.shape[0]
        self.constant("supports", sup)   # (2, N, N)
        # each symmetric support's eigenbasis, once, on the host in f64;
        # an asymmetric one has no orthogonal eigenbasis and takes RK4
        self.spectral = []
        for v in range(self.num_views):
            a64 = np.asarray(sup[v], np.float64)
            spectral = ode_solver == "spectral" and np.allclose(a64, a64.T, atol=1e-6)
            if spectral:
                lam, u = np.linalg.eigh(a64)
                self.constant("eig{}_u".format(v), u)
                self.constant("eig{}_lam".format(v), lam)
            self.spectral.append(spectral)
        c = hidden_dim
        self.param("lift_kernel", (input_dim, c), "dense")
        self.param("lift_bias", (c,), "zeros")
        for v in range(self.num_views):
            for blk in range(num_blocks):
                name = "v{}b{}".format(v, blk)
                self.param(name + "_t1_kernel", (kt, c, 2 * c), "torch")
                self.param(name + "_t1_bias", (2 * c,), "zeros")
                self.param(name + "_ode_alpha", (c,), "zeros")
                self.param(name + "_t2_kernel", (kt, c, 2 * c), "torch")
                self.param(name + "_t2_bias", (2 * c,), "zeros")
        self.param("head1_kernel", (t_rem * c, head_dim), "dense")
        self.param("head1_bias", (head_dim,), "zeros")
        self.param("head2_kernel", (head_dim, output_window * output_dim), "dense")
        self.param("head2_bias", (output_window * output_dim,), "zeros")
        # the RK4 step's f32 constants, as the JAX package rounds them
        dt = np.float32(1.0) / np.float32(ode_steps)
        self._rk4 = tuple(float(v) for v in (dt, np.float32(0.5) * dt, dt / np.float32(6.0)))

    def _ode_rk4(self, h, alpha, a):
        """RK4 integration of dH/dt = alpha (A H - H) + H0 over [0, 1]."""
        dt, half, sixth = self._rk4
        h0 = h

        def f(y):
            return alpha * (torch.einsum("nm,btmc->btnc", a, y) - y) + h0

        y = h
        for _ in range(self.ode_steps):
            k1 = f(y)
            k2 = f(y + half * k1)
            k3 = f(y + half * k2)
            k4 = f(y + dt * k3)
            y = y + sixth * (k1 + 2 * k2 + 2 * k3 + k4)
        return y

    @staticmethod
    def _ode_spectral(h, alpha, u, lam):
        """The same ODE solved exactly in A's eigenbasis: (e^z + phi1(z))
        on the eigencoordinates, z = alpha (lam - 1), phi1(z) = (e^z - 1) / z."""
        z = alpha[None, :] * (lam[:, None] - 1.0)   # (N, C), z <= 0
        small = torch.abs(z) < 1e-12   # the removable singularity at 0 (lam = 1)
        safe = torch.where(small, torch.ones_like(z), z)
        phi1 = torch.where(small, 1.0 + 0.5 * z, torch.expm1(safe) / safe)
        scale = torch.exp(z) + phi1
        hhat = torch.einsum("nk,btnc->btkc", u, h)
        return torch.einsum("nk,btkc->btnc", u, hhat * scale)

    def _gated_tcn(self, name, x):
        """tanh(P) * sigmoid(Q) of a temporal conv, kt - 1 steps shorter, plus the input's tail."""
        wk = getattr(self, name + "_kernel")
        y = sum(s @ wk[j] for j, s in enumerate(temporal_slices(x, self.kt))) + getattr(self, name + "_bias")
        p, q = y.split(self.hidden_dim, dim=-1)
        return torch.tanh(p) * torch.sigmoid(q) + x[:, self.kt - 1:]

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        h = self.linear(x[..., : self.input_dim], "lift")   # (B, T, N, C)
        outs = []
        for v in range(self.num_views):
            for blk in range(self.num_blocks):
                name = "v{}b{}".format(v, blk)
                z = self._gated_tcn(name + "_t1", h)
                alpha = torch.sigmoid(getattr(self, name + "_ode_alpha"))
                if self.spectral[v]:
                    z = self._ode_spectral(z, alpha, getattr(self, "eig{}_u".format(v)),
                                           getattr(self, "eig{}_lam".format(v)))
                else:
                    z = self._ode_rk4(z, alpha, self.supports[v])
                outs.append(self._gated_tcn(name + "_t2", z))
        agg = torch.amax(torch.stack(outs), dim=0)   # ties share the gradient, as JAX's max
        if agg.shape[1] != self.t_rem:
            raise ValueError("built for {} steps after the blocks, the input leaves {}".format(
                self.t_rem, agg.shape[1]))
        flat = agg.permute(0, 2, 1, 3).reshape(b, n, self.t_rem * self.hidden_dim)
        y = self.linear(torch.relu(self.linear(flat, "head1")), "head2")
        return to_horizons(y, b, n, self.output_window, self.output_dim)


def build_stgode(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> STGODE:
    adj = np.asarray(data_feature.get("adj_mx"), np.float32)
    profiles = data_feature.get("node_profiles")
    if profiles is None:   # no daily profiles: the adjacency rows stand for them, as in JAX
        profiles = adj
    dist = dtw_profile_distances(np.asarray(profiles, np.float32), band=int(config.get("stgode_dtw_band", 4)))
    sem = semantic_adjacency_from_dtw(dist, float(config.get("stgode_sparsity", 0.1)))
    model = STGODE(
        supports=np.stack([_sym_norm_with_self_loops(adj), _sym_norm_with_self_loops(sem)]),
        input_window=config.get("input_window", 12),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        kt=config.get("kt", 3),
        num_blocks=config.get("stgode_blocks", 3),
        ode_steps=config.get("ode_steps", 6),
        head_dim=config.get("stgode_head_dim", 128),
        ode_solver=config.get("stgode_solver", "spectral"),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
