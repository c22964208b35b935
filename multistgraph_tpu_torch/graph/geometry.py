"""Geographic geometry helpers (host-side, build-time numpy).

Counterpart of multistgraph_tpu/graph/geometry.py: haversine distance on a
6371 km sphere and the Gaussian-kernel distance adjacency
(ref: MultiATGCN.py:41-56). The .geo table is a column dict.
"""

import ast
from typing import Dict, Tuple

import numpy as np


def haversine(lat1, lng1, lat2, lng2) -> np.ndarray:
    """Great-circle distance in km; inputs in degrees, broadcastable arrays."""
    lat1, lng1, lat2, lng2 = map(np.radians, (lat1, lng1, lat2, lng2))
    dlat = lat2 - lat1
    dlng = lng2 - lng1
    d = np.sin(dlat * 0.5) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlng * 0.5) ** 2
    return 2 * 6371.0 * np.arcsin(np.sqrt(d))


def gaussian_kernel_adjacency(dist_mx: np.ndarray, epsilon: float = 0.0) -> np.ndarray:
    """w_ij = exp(-(d_ij/std)^2) with entries < epsilon zeroed; std over finite entries."""
    dist_mx = np.asarray(dist_mx, dtype=np.float64)
    std = dist_mx[~np.isinf(dist_mx)].flatten().std()
    adj = np.exp(-np.square(dist_mx / std))
    adj[adj < epsilon] = 0.0
    return adj.astype(np.float32)


def parse_coordinates(geo: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """(lng, lat) from the '[lng, lat]' strings of the 'coordinates' column,
    in geo_id-sorted row order (the reference's pandas pivot sorts its index)."""
    order = np.argsort(np.asarray(geo["geo_id"]), kind="stable")
    coords = np.array([ast.literal_eval(str(geo["coordinates"][i])) for i in order],
                      dtype=np.float64)
    return coords[:, 0], coords[:, 1]


def haversine_distance_matrix(geo: Dict[str, np.ndarray]) -> np.ndarray:
    lng, lat = parse_coordinates(geo)
    return haversine(lat[:, None], lng[:, None], lat[None, :], lng[None, :])
