"""STG-NCDE, the spatio-temporal graph neural controlled differential equation.

Counterpart of multistgraph_tpu/models/stgncde.py (Choi et al., AAAI 2022),
on the zoo's shared API (models/zoo.py), the JAX parameter names. Two
stacked CDEs are driven by a control path X(t) through the input series
over t in [0, Tin - 1]:

  temporal:  dh/dt = f(h(t)) . X'(t)     f: (B, N, Dh) -> (B, N, Dh, Fin)
  spatial:   dz/dt = g(z(t)) . h'(t)     g: (B, N, Dh) -> (B, N, Dh, Dh)

f is a per-node MLP with a tanh head; g an adaptive Chebyshev graph conv
(node embeddings E, adjacency softmax(relu(E E^T)), node-conditioned
weight pools) with a tanh head. Both integrate together by RK4, ``substeps``
a unit interval; the head maps z(Tin - 1) to every horizon. The control is
piecewise linear (``ncde_control='linear'``, X' constant on each interval)
or the natural cubic spline (``'cubic'``, ``natural_cubic_coeffs``: a
Thomas forward sweep and back substitution, X' evaluated per RK4 stage).

g's contraction is reassociated as in JAX: the embedding folds into the
activations, so each evaluation is one (B N, K I D) @ (K I D, Dh^2) matmul
on ``pool_mat`` = pool permuted (K, I, D, Dh^2), with ``emb @ bias_pool``
as its bias; ``compute_dtype='bfloat16'`` rounds ``pool_mat``, ``emb`` and
the graph-conv output to bf16 and sums the product in f32. Each interval's
step is checkpointed (``torch.utils.checkpoint``, non-reentrant, the RNG
state preserved): the backward keeps only the (B, N, Dh) states between
intervals and recomputes each step's RK4 stages, the memory shape of the
JAX package's ``jax.checkpoint``.
"""

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from multistgraph_tpu_torch.models.zoo import ZooModule, finish, to_horizons
from multistgraph_tpu_torch.utils import resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def natural_cubic_coeffs(xx: torch.Tensor):
    """The natural cubic spline through xx (B, T, N, F) at unit knots, as
    the per-interval coefficients (b, c, d), each (T-1, B, N, F), of
    X'(i + s) = b_i + 2 c_i s + 3 d_i s^2 on s in [0, 1]. The second
    derivatives M solve M_{i-1} + 4 M_i + M_{i+1} = 6 (y_{i+1} - 2 y_i +
    y_{i-1}), M_0 = M_T = 0, by a Thomas forward sweep and a back
    substitution over T."""
    y = xx.permute(1, 0, 2, 3)   # (T, B, N, F)
    if y.shape[0] == 2:   # no interior knot: the chord
        return y[1:] - y[:-1], torch.zeros_like(y[:-1]), torch.zeros_like(y[:-1])
    rhs = 6.0 * (y[2:] - 2.0 * y[1:-1] + y[:-2])
    zero = torch.zeros_like(rhs[0])
    cp, dp = zero, zero
    cps, dps = [], []
    for r in rhs:
        denom = 4.0 - cp
        cp, dp = 1.0 / denom, (r - dp) / denom
        cps.append(cp)
        dps.append(dp)
    m_next, ms = zero, []
    for cp, dp in zip(reversed(cps), reversed(dps)):
        m_next = dp - cp * m_next
        ms.append(m_next)
    m = torch.stack([zero] + ms[::-1] + [zero])   # (T, ...), M_0 = M_T = 0
    b = (y[1:] - y[:-1]) - (2.0 * m[:-1] + m[1:]) / 6.0
    return b, m[:-1] / 2.0, (m[1:] - m[:-1]) / 6.0


class STGNCDE(ZooModule):
    """Stacked temporal and spatial neural CDEs with an adaptive graph field."""

    def __init__(self, num_nodes: int, output_window: int, output_dim: int, input_dim: int = 1,
                 hidden_dim: int = 64, field_dim: int = 64, embed_dim: int = 10, cheb_k: int = 2,
                 substeps: int = 1, control: str = "linear", compute_dtype: Optional[str] = None, device=None):
        super().__init__(output_dim, device)
        self.num_nodes = num_nodes
        self.output_window = output_window
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.cheb_k = cheb_k
        self.substeps = substeps
        self.control = control
        self.cdtype = _DTYPES[compute_dtype] if compute_dtype else None
        dh = hidden_dim
        for name, dim_in, dim_out in (("init_h", input_dim, dh), ("init_z", input_dim, dh),
                                      ("f1", dh, field_dim), ("f2", field_dim, field_dim),
                                      ("f3", field_dim, dh * input_dim), ("g1", dh, field_dim)):
            self.param(name + "_kernel", (dim_in, dim_out), "dense")
            self.param(name + "_bias", (dim_out,), "zeros")
        self.param("node_emb", (num_nodes, embed_dim), "torch")
        self.param("g_pool", (embed_dim, cheb_k, field_dim, dh * dh), "torch")
        self.param("g_bias_pool", (embed_dim, dh * dh), "torch")
        self.param("head_kernel", (dh, output_window * output_dim), "dense")
        self.param("head_bias", (output_window * output_dim,), "zeros")
        # RK4's f32 constants, as the JAX package rounds them: dt, dt/2,
        # dt/6, and each substep's s at its start, middle and end (and s^2)
        dt = np.float32(1.0) / np.float32(substeps)
        half = np.float32(0.5) * dt
        self._dt = tuple(float(v) for v in (dt, half, dt / np.float32(6.0)))
        self._s = []
        for r in range(substeps):
            s0 = np.float32(r) * dt
            self._s.append(tuple((float(s), float(s * s)) for s in (s0, s0 + half, s0 + dt)))

    def _f(self, h):
        """The temporal field: (B, N, Dh) -> (B, N, Dh, Fin)."""
        y = torch.relu(self.linear(h, "f1"))
        y = torch.relu(self.linear(y, "f2"))
        return torch.tanh(self.linear(y, "f3")).reshape(*h.shape[:2], self.hidden_dim, self.input_dim)

    def _rounded(self, t):
        """t rounded to compute_dtype and held in f32: the products of two
        such values are exact in f32 and sum in f32, and the gradient that
        reaches t is rounded as JAX rounds a bf16 value's cotangent."""
        return t if self.cdtype is None else t.to(self.cdtype).float()

    def _g(self, z, supports, emb_c, pool_mat, bpool):
        """The spatial field: (B, N, Dh) -> (B, N, Dh, Dh), one
        (B N, K I D) @ (K I D, Dh^2) product with the embedding folded in."""
        b, n, _ = z.shape
        y = torch.relu(self.linear(z, "g1"))
        yg = self._rounded(torch.einsum("knm,bmc->bknc", supports, y))
        yge = self._rounded((yg.permute(0, 2, 1, 3)[..., None] * emb_c[None, :, None, None, :]).reshape(b, n, -1))
        return torch.tanh(yge @ pool_mat + bpool).reshape(b, n, self.hidden_dim, self.hidden_dim)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        b, t, n, _f = x.shape
        if t < 2:
            raise ValueError("STG-NCDE needs at least 2 input steps")
        xx = x[..., : self.input_dim]
        h0 = self.linear(xx[:, 0], "init_h")
        z0 = self.linear(xx[:, 0], "init_z")

        emb = self.node_emb
        adapt = torch.softmax(torch.relu(emb @ emb.t()), dim=1)
        sups = [torch.eye(n, dtype=x.dtype, device=x.device), adapt]
        for _ in range(2, self.cheb_k):
            sups.append(2.0 * sups[1] @ sups[-1] - sups[-2])
        supports = torch.stack(sups[: max(self.cheb_k, 1)])   # (K, N, N)
        d_emb, k, i, o = self.g_pool.shape
        pool_mat = self.g_pool.permute(1, 2, 0, 3).reshape(k * i * d_emb, o)
        bpool = emb @ self.g_bias_pool
        pool_mat, emb_c = self._rounded(pool_mat), self._rounded(emb)

        def field(h, z, dxdt):
            dhdt = torch.einsum("bndf,bnf->bnd", self._f(h), dxdt)
            dzdt = torch.einsum("bnde,bne->bnd", self._g(z, supports, emb_c, pool_mat, bpool), dhdt)
            return dhdt, dzdt

        if self.control == "cubic":
            coeffs = natural_cubic_coeffs(xx)   # X'(i + s) = b_i + 2 c_i s + 3 d_i s^2

            def dx_at(ci, s):
                bi, cc, di = ci
                return bi + 2.0 * cc * s[0] + 3.0 * di * s[1]
        else:   # piecewise linear: X' constant on [i, i+1)
            coeffs = ((xx[:, 1:] - xx[:, :-1]).permute(1, 0, 2, 3),)

            def dx_at(ci, s):
                return ci[0]

        dt, half, sixth = self._dt

        def step(h, z, *ci):
            for s0, smid, s1 in self._s:
                k1 = field(h, z, dx_at(ci, s0))
                dx_mid = dx_at(ci, smid)
                k2 = field(h + half * k1[0], z + half * k1[1], dx_mid)
                k3 = field(h + half * k2[0], z + half * k2[1], dx_mid)
                k4 = field(h + dt * k3[0], z + dt * k3[1], dx_at(ci, s1))
                h = h + sixth * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
                z = z + sixth * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
            return h, z

        h, z = h0, z0
        for interval in range(t - 1):
            ci = tuple(c[interval] for c in coeffs)
            if torch.is_grad_enabled():
                h, z = checkpoint(step, h, z, *ci, use_reentrant=False, preserve_rng_state=True)
            else:
                h, z = step(h, z, *ci)
        return to_horizons(self.linear(z, "head"), b, n, self.output_window, self.output_dim)


def build_stgncde(config, data_feature, device=None, generator: Optional[torch.Generator] = None) -> STGNCDE:
    model = STGNCDE(
        num_nodes=data_feature.get("num_nodes", 1),
        output_window=config.get("output_window", 1),
        output_dim=data_feature.get("output_dim", 1),
        input_dim=data_feature.get("feature_dim", 1),
        hidden_dim=config.get("rnn_units", 64),
        field_dim=config.get("ncde_field_dim", 64),
        embed_dim=config.get("embed_dim_node", 10),
        cheb_k=config.get("cheb_order", 2),
        substeps=config.get("ncde_substeps", 1),
        control=config.get("ncde_control", "linear"),
        compute_dtype=config.get("compute_dtype", None),
        device=resolve_device(device),
    )
    return finish(model, config, generator)
