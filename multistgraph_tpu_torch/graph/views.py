"""Multi-view adjacency construction for MultiATGCN (host-side, build-time numpy).

Counterpart of multistgraph_tpu/graph/views.py (ref: MultiATGCN.py:237-283):

  * OD view:        column-normalize the raw OD matrix by its diagonal, clip at 1;
  * semantic view:  inverse euclidean distance between static node features;
  * distance view:  haversine distances + Gaussian kernel (epsilon=0.1);
  * support pairs:  each selected view contributes [I, scaled_laplacian(A)].

The .geo table is a column dict in place of the JAX package's DataFrame.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.distance import cdist

from multistgraph_tpu_torch.graph.geometry import gaussian_kernel_adjacency, haversine_distance_matrix
from multistgraph_tpu_torch.graph.laplacian import scaled_laplacian

VALID_ADJTYPES = ("multi", "od", "dist", "cosine", "identity")


def od_view(adj_mx: np.ndarray) -> np.ndarray:
    """Column-normalized OD adjacency, clipped at 1."""
    adj = np.asarray(adj_mx, dtype=np.float32)
    diag = np.diag(adj).copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        out = adj / diag[None, :]
    out[out > 1] = 1.0
    return out


def semantic_view(static: Optional[np.ndarray], num_nodes: int) -> np.ndarray:
    """Inverse-euclidean similarity of static features; identity without them."""
    if static is None:
        return np.eye(num_nodes, dtype=np.float32)
    euc = cdist(static, static, metric="euclidean")
    euc[euc == 0] = 1.0
    return (1.0 / euc).astype(np.float32)


def distance_view(geo: Dict[str, np.ndarray], epsilon: float = 0.1) -> np.ndarray:
    return gaussian_kernel_adjacency(haversine_distance_matrix(geo), epsilon)


def build_views(
    adj_mx: Optional[np.ndarray],
    static: Optional[np.ndarray],
    geo: Optional[Dict[str, np.ndarray]],
    num_nodes: int,
    adjtype: str,
) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
    """(base_adj, support pairs) for an adjtype; 'multi' orders the views od, dist, cosine."""
    if adjtype not in VALID_ADJTYPES:
        raise ValueError("adjtype must be one of {}, got {!r}".format(VALID_ADJTYPES, adjtype))
    identity = np.eye(num_nodes, dtype=np.float32)

    adj_od = od_view(adj_mx) if adj_mx is not None else identity
    adj_cos = semantic_view(static, num_nodes)
    adj_dis = distance_view(geo) if geo is not None else identity

    def pair(adj):
        return [identity, scaled_laplacian(adj).astype(np.float32)]

    if adjtype == "multi":
        return adj_od, [pair(adj_od), pair(adj_dis), pair(adj_cos)]
    if adjtype == "od":
        return adj_od, [pair(adj_od)]
    if adjtype == "dist":
        return adj_dis, [pair(adj_dis)]
    if adjtype == "cosine":
        return adj_cos, [pair(adj_cos)]
    return identity, [[identity, identity]]


def stack_static_supports(supports: List[List[np.ndarray]], cheb_k: int) -> np.ndarray:
    """[I] + each view's Chebyshev terms T_1..T_{K-1}, stacked (1 + views*(K-1), N, N)."""
    n = supports[0][0].shape[0]
    out = [np.eye(n, dtype=np.float32)]
    for view in supports:
        terms = [m.astype(np.float32) for m in view]
        for _ in range(2, cheb_k):
            terms.append(2.0 * terms[1] @ terms[-1] - terms[-2])
        out.extend(terms[1:])
    return np.stack(out, axis=0)
