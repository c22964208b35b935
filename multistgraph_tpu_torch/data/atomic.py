"""Readers for the LibCity atomic files the point path uses, on csv and numpy.

Counterpart of multistgraph_tpu/data/atomic.py with the same formats and
column-selection rules, without pandas: a file is read into a *column dict*
(``{name: np.ndarray}``, in file order) whose column types are inferred the
way pandas infers them for these files (int64, else float64 with empty
cells as NaN, else str).

Formats:
  .geo    CSV [geo_id, type, coordinates, properties...]
  .rel    CSV [rel_id, type, origin_id, destination_id, props...]
  .dyna   CSV [dyna_id, type, time, entity_id, properties...]
  .ext    CSV [ext_id, time, properties...]
  .static CSV [id, features...]
  .gbst   CSV per-node group stats incl. geo_id/All_m/All_std

Grid and OD readers are not ported yet.
"""

import csv
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

Columns = Dict[str, np.ndarray]


def _infer(values: Sequence[str]) -> np.ndarray:
    raw = np.asarray(values, dtype=str)
    empty = raw == ""
    if not empty.any():
        try:
            return raw.astype(np.int64)
        except ValueError:
            pass
    try:
        out = np.where(empty, "nan", raw).astype(np.float64)
        return out
    except ValueError:
        return raw


def read_csv(path: str) -> Columns:
    """Read a csv file with a header row into a column dict."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    if rows:
        cols = list(zip(*rows))
    else:
        cols = [()] * len(header)
    return {name: _infer(col) for name, col in zip(header, cols)}


def isna(col: np.ndarray) -> np.ndarray:
    """Missing cells of a column read by `read_csv`."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "U":
        return col == ""
    return np.zeros(col.shape, dtype=bool)


def take_rows(columns: Columns, index) -> Columns:
    return {k: v[index] for k, v in columns.items()}


def _timestamps(time_col: np.ndarray) -> Optional[np.ndarray]:
    """datetime64[ns] after the reference's T/Z cleanup, or None if a cell is empty."""
    if isna(time_col).any():
        return None
    cleaned = np.char.replace(np.char.replace(time_col.astype(str), "T", " "), "Z", "")
    return np.array(cleaned, dtype="datetime64[ns]")


def _select(columns: Columns, data_col, key_cols: List[str], skip: int) -> Columns:
    if data_col:
        cols = list(data_col) if isinstance(data_col, (list, tuple)) else [data_col]
        return {c: columns[c] for c in key_cols + cols}
    return {c: columns[c] for c in list(columns)[skip:]}


def _stack(columns: Columns, names: List[str]) -> np.ndarray:
    n = len(next(iter(columns.values()))) if columns else 0
    if not names:
        return np.zeros((n, 0), np.float64)
    return np.stack([columns[c].astype(np.float64) for c in names], axis=1)


@dataclass
class GeoTable:
    columns: Columns
    geo_ids: List = field(default_factory=list)
    geo_to_ind: Dict = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return len(self.geo_ids)


def load_geo(path: str) -> GeoTable:
    columns = read_csv(path)
    geo_ids = columns["geo_id"].tolist()
    return GeoTable(columns=columns, geo_ids=geo_ids,
                    geo_to_ind={g: i for i, g in enumerate(geo_ids)})


def load_rel(
    path: str,
    geo: GeoTable,
    weight_col: Union[str, List[str], None] = "",
    set_weight_link_or_dist: str = "dist",
    init_weight_inf_or_zero: str = "zero",
    bidir_adj_mx: bool = False,
    calculate_weight_adj: bool = False,
    weight_adj_epsilon: float = 0.1,
    distance_inverse: bool = False,
) -> np.ndarray:
    """Dense N x N adjacency from a .rel file (same rules as the JAX reader:
    explicit weight_col wins; 4 columns -> 0/1 links; 5 columns -> the last
    column is the weight; 'inf'/'zero' init, Gaussian kernel or inverse
    distance on request)."""
    rel = read_csv(path)
    names = list(rel)
    if isinstance(weight_col, list):
        if len(weight_col) != 1:
            raise ValueError("`weight_col` parameter must be only one column!")
        weight_col = weight_col[0]
    if weight_col:
        edges = take_rows(rel, ~isna(rel[weight_col]))
    else:
        if len(names) > 5 or len(names) < 4:
            raise ValueError("Don't know which column to be loaded! Please set `weight_col`!")
        if len(names) == 4:
            calculate_weight_adj = False
            set_weight_link_or_dist = "link"
            init_weight_inf_or_zero = "zero"
            edges = {"origin_id": rel["origin_id"], "destination_id": rel["destination_id"]}
            weight_col = None
        else:
            weight_col = names[-1]
            edges = take_rows(rel, ~isna(rel[weight_col]))

    n = geo.num_nodes
    link_mode = set_weight_link_or_dist.lower() == "link"
    adj = np.zeros((n, n), dtype=np.float32)
    if init_weight_inf_or_zero.lower() == "inf" and not link_mode:
        adj[:] = np.inf

    src = np.array([geo.geo_to_ind.get(g, -1) for g in edges["origin_id"].tolist()], np.int64)
    dst = np.array([geo.geo_to_ind.get(g, -1) for g in edges["destination_id"].tolist()], np.int64)
    keep = (src >= 0) & (dst >= 0)
    src, dst = src[keep], dst[keep]
    if link_mode or weight_col is None:
        w = np.ones(len(src), dtype=np.float32)
    else:
        w = edges[weight_col][keep].astype(np.float32)
    adj[src, dst] = w
    if bidir_adj_mx:
        adj[dst, src] = w

    if not link_mode:
        if distance_inverse:
            with np.errstate(divide="ignore"):
                adj = (1.0 / adj).astype(np.float32)
            adj[np.isinf(adj)] = 1.0
        elif calculate_weight_adj:
            finite = adj[~np.isinf(adj)].flatten()
            std = finite.std()
            adj = np.exp(-np.square(adj / std)).astype(np.float32)
            adj[adj < weight_adj_epsilon] = 0.0
    return adj


@dataclass
class DynaData:
    values: np.ndarray            # (len_time, num_nodes, feature_dim)
    timestamps: Optional[np.ndarray]  # datetime64[ns] of length len_time, or None


def load_dyna(path: str, geo: GeoTable, data_col: Union[str, Sequence[str], None] = "") -> DynaData:
    """A .dyna file as (len_time, num_nodes, feature_dim).

    Rows are entity-major (all timesteps of node 0, then node 1, ...), in the
    node order of the .geo file.
    """
    df = _select(read_csv(path), data_col, ["time", "entity_id"], skip=2)
    n = geo.num_nodes
    len_time = len(df["time"]) // n
    timestamps = _timestamps(df["time"][:len_time])
    feature_cols = [c for c in df if c not in ("time", "entity_id")]
    values = _stack(df, feature_cols).reshape(n, len_time, len(feature_cols))
    return DynaData(values=values.swapaxes(0, 1), timestamps=timestamps)


@dataclass
class ExtData:
    values: np.ndarray            # (len_time_ext, ext_dim)
    timestamps: Optional[np.ndarray]


def load_ext(path: str, ext_col: Union[str, Sequence[str], None] = "") -> ExtData:
    df = _select(read_csv(path), ext_col, ["time"], skip=1)
    feature_cols = [c for c in df if c != "time"]
    return ExtData(values=_stack(df, feature_cols), timestamps=_timestamps(df["time"]))


def load_static(path: str) -> np.ndarray:
    """Load .static, dropping the leading id column."""
    columns = read_csv(path)
    return _stack(columns, list(columns)[1:])


def load_gbst(path: str) -> Columns:
    """Load .gbst per-node group stats sorted by geo_id."""
    columns = read_csv(path)
    return take_rows(columns, np.argsort(columns["geo_id"], kind="stable"))
