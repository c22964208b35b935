"""Graph Laplacians (host-side, build-time numpy).

Counterpart of the part of multistgraph_tpu/graph/laplacian.py that the
MultiATGCN supports use:
  * normalized Laplacian  L = I - D^{-1/2} A D^{-1/2}  (ref: MultiATGCN.py:15-23)
  * scaled Laplacian      L~ = 2 L / lambda_max - I    (ref: MultiATGCN.py:26-38)
"""

from typing import Optional

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
