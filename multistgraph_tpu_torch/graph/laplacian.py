"""Graph Laplacians and support matrices (host-side, build-time numpy).

Counterpart of multistgraph_tpu/graph/laplacian.py, the same numpy
arithmetic:
  * normalized Laplacian  L = I - D^{-1/2} A D^{-1/2}  (ref: MultiATGCN.py:15-23)
  * scaled Laplacian      L~ = 2 L / lambda_max - I    (ref: MultiATGCN.py:26-38)
  * random-walk matrix    D^{-1} A                     (ref: libcity/model/utils.py:116-126)
  * Chebyshev recursion   T_k = 2 S T_{k-1} - T_{k-2}  (ref: libcity/model/utils.py:42-59)
  * the support list of a DCRNN ``filter_type``        (ref: libcity/model/utils.py:62-85)
"""

from typing import List, Optional

import numpy as np


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """L = I - D^{-1/2} A D^{-1/2} with rows of zero degree contributing 0."""
    adj = np.asarray(adj, dtype=np.float64)
    d = adj.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(d, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    # the reference's operand order: (A @ D^{-1/2}).T @ D^{-1/2}
    norm = (adj * d_inv_sqrt[None, :]).T * d_inv_sqrt[None, :]
    return np.eye(adj.shape[0]) - norm


def scaled_laplacian(adj: np.ndarray, lambda_max: Optional[float] = 2.0,
                     undirected: bool = False) -> np.ndarray:
    """L~ = 2 L / lambda_max - I; lambda_max=None -> largest eigenvalue of L."""
    adj = np.asarray(adj, dtype=np.float64)
    if undirected:
        adj = np.maximum(adj, adj.T)
    lap = normalized_laplacian(adj)
    if lambda_max is None:
        lambda_max = float(np.max(np.linalg.eigvalsh((lap + lap.T) / 2)))
    return ((2.0 / lambda_max) * lap - np.eye(lap.shape[0])).astype(np.float32)


def random_walk_matrix(adj: np.ndarray) -> np.ndarray:
    """D^{-1} A with zero-degree rows left as zeros."""
    adj = np.asarray(adj, dtype=np.float64)
    d = adj.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv = 1.0 / d
    d_inv[np.isinf(d_inv)] = 0.0
    return (d_inv[:, None] * adj).astype(np.float32)


def cheb_polynomials(support: np.ndarray, order: int) -> List[np.ndarray]:
    """[T_0=I, T_1=S, T_2=2S T_1 - T_0, ...] up to T_{order-1}."""
    n = support.shape[0]
    polys = [np.eye(n, dtype=np.float32)]
    if order >= 2:
        polys.append(support.astype(np.float32))
    for _ in range(2, order):
        polys.append(2.0 * support @ polys[-1] - polys[-2])
    return polys[:order]


def supports_by_filter_type(adj: np.ndarray, filter_type: str) -> List[np.ndarray]:
    """'laplacian' -> [scaled Laplacian (lambda_max=None, undirected)];
    'random_walk' -> [(D^{-1}A)^T]; 'dual_random_walk' -> the forward and
    backward walks, transposed; anything else -> the scaled Laplacian."""
    if filter_type == "random_walk":
        return [random_walk_matrix(adj).T]
    if filter_type == "dual_random_walk":
        return [random_walk_matrix(adj).T, random_walk_matrix(adj.T).T]
    return [scaled_laplacian(adj, lambda_max=None, undirected=True)]
