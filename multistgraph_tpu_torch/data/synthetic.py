"""Synthetic atomic-dataset generator, written with the csv module.

Counterpart of multistgraph_tpu/data/synthetic.py: the same seed draws the
same random numbers in the same order and writes the same files
(.geo/.rel/.dyna/.ext/.static/.gbst + config.json, the DC schema) with the
same cells: floats are written as Python's shortest round-trip repr, which
is what pandas' ``to_csv`` writes, and fields with commas are quoted.
"""

import csv
import json
import os

import numpy as np

from multistgraph_tpu_torch.data.atomic import read_csv
from multistgraph_tpu_torch.utils import ensure_dir


def _write_csv(path: str, columns: dict, num_rows: int) -> None:
    """Write a column dict; a str value is repeated on every row."""
    cols = [[v] * num_rows if isinstance(v, str) else np.asarray(v).tolist()
            for v in columns.values()]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(columns))
        writer.writerows(zip(*cols))


def make_synthetic_dataset(
    out_dir: str,
    name: str,
    num_nodes: int = 8,
    len_time: int = 24 * 40,
    start_time: str = "2019-01-01T00:00:00Z",
    node_mean: float = 30.0,
    node_std: float = 15.0,
    seed: int = 0,
    groupstd_normalize: bool = True,
    node_stats=None,
) -> str:
    """Write a full synthetic dataset under `out_dir/name/`; returns its path.

    `node_stats` (a column dict or a CSV path with All_m/All_std columns)
    anchors the per-node marginals; bootstrapped when its row count differs
    from num_nodes. See the JAX generator for what each component models.
    """
    rng = np.random.default_rng(seed)
    path = os.path.join(out_dir, name)
    ensure_dir(path)

    geo_ids = np.arange(11001000100, 11001000100 + num_nodes)
    lng = -77.0 + rng.uniform(-0.2, 0.2, num_nodes)
    lat = 38.9 + rng.uniform(-0.2, 0.2, num_nodes)
    _write_csv(os.path.join(path, name + ".geo"), {
        "geo_id": geo_ids,
        "type": "Point",
        "coordinates": ["[{:.6f}, {:.6f}]".format(x, y) for x, y in zip(lng, lat)],
    }, num_nodes)

    # OD flows: distance-decayed random volumes with a strong self-flow
    # diagonal; link_weight is the destination-normalized fraction.
    d2 = (lng[:, None] - lng[None, :]) ** 2 + (lat[:, None] - lat[None, :]) ** 2
    volume = rng.poisson(50 * np.exp(-d2 / 0.02)) + np.diag(rng.integers(100, 200, num_nodes))
    src, dst = np.nonzero(volume)
    inflow = np.maximum(volume.sum(axis=0, keepdims=True), 1)
    frac = volume / inflow
    _write_csv(os.path.join(path, name + ".rel"), {
        "rel_id": np.arange(len(src)),
        "type": "geo",
        "origin_id": geo_ids[src],
        "destination_id": geo_ids[dst],
        "link_weight": frac[src, dst].astype(float),
    }, len(src))

    times = np.datetime64(start_time.replace("T", " ").replace("Z", "")) + np.arange(
        len_time) * np.timedelta64(3600, "s")
    hours = np.arange(len_time)
    if node_stats is not None:
        stats = read_csv(node_stats) if isinstance(node_stats, (str, os.PathLike)) else node_stats
        m = np.asarray(stats["All_m"], np.float64)
        s = np.asarray(stats["All_std"], np.float64)
        if len(m) != num_nodes:
            pick = rng.integers(0, len(m), num_nodes)
            m, s = m[pick], s[pick]
        means = np.maximum(m, 1.0)
        stds = np.maximum(s, 0.5)
    else:
        means = np.maximum(rng.normal(node_mean, node_mean / 2, num_nodes), 1.0)
        stds = np.maximum(rng.normal(node_std, node_std / 3, num_nodes), 0.5)
    phase = rng.uniform(0, 2 * np.pi, num_nodes)
    daily = (
        np.sin(2 * np.pi * hours[None, :] / 24 + phase[:, None])
        + 0.5 * np.sin(4 * np.pi * hours[None, :] / 24 + 2 * phase[:, None])
    )
    day_idx = times.astype("datetime64[D]").astype(np.int64)
    weekday_series = (day_idx + 3) % 7  # 2019-01-01 was a Tuesday
    weekend = (weekday_series >= 5).astype(float)
    weekly = -0.5 * weekend[None, :] + 0.25 * np.sin(
        2 * np.pi * hours[None, :] / (24 * 7) + phase[:, None])
    slope = rng.normal(0, 0.4, num_nodes)
    trend = slope[:, None] * (hours[None, :] / max(len_time - 1, 1)) + 0.3 * np.sin(
        2 * np.pi * hours[None, :] / (24 * 28) + phase[:, None])
    # OD-mixed AR(1): innovations half own, half neighborhood average
    w_od = volume.astype(np.float64).copy()
    np.fill_diagonal(w_od, 0.0)
    w_od = w_od / np.maximum(w_od.sum(axis=1, keepdims=True), 1e-9)
    ar = np.zeros((num_nodes, len_time), np.float64)
    amp = np.zeros((num_nodes, len_time), np.float64)
    phi, phi_amp = 0.96, 0.995
    sig_ar = np.sqrt(1.0 - phi**2)
    sig_amp = np.sqrt(1.0 - phi_amp**2)
    state = rng.normal(0, 1, num_nodes)
    state_amp = rng.normal(0, 1, num_nodes)
    for t in range(len_time):
        white = rng.normal(0, 1, num_nodes)
        state = phi * state + sig_ar * (0.5 * white + 0.5 * (w_od @ white))
        state_amp = phi_amp * state_amp + sig_amp * rng.normal(0, 1, num_nodes)
        ar[:, t] = state
        amp[:, t] = state_amp
    # hour-of-week profile drifting week to week (weekly AR(1), phi=0.85)
    n_weeks = len_time // (24 * 7) + 2
    kernel = np.exp(-0.5 * ((np.arange(-8, 9)) / 3.0) ** 2)
    kernel /= kernel.sum()

    def smooth168(a):
        ext = np.concatenate([a[..., -16:], a, a[..., :16]], axis=-1)
        sm = np.apply_along_axis(lambda v: np.convolve(v, kernel, mode="same"), -1, ext)
        sm = sm[..., 16:-16]
        return sm / max(sm.std(), 1e-9)

    phi_w = 0.85

    def how_innov():
        raw = smooth168(rng.normal(0, 1.0, (num_nodes, 168)))
        mixed = 0.5 * raw + 0.5 * (w_od @ raw)
        return mixed / max(mixed.std(), 1e-9)

    profile = np.empty((n_weeks, num_nodes, 168))
    profile[0] = how_innov()
    for w in range(1, n_weeks):
        profile[w] = phi_w * profile[w - 1] + np.sqrt(1 - phi_w**2) * how_innov()
    how_comp = profile[hours // 168, :, hours % 168].T  # (N, T)

    noise = rng.normal(0, 0.15, (num_nodes, len_time))
    visits = np.maximum(
        means[:, None]
        + stds[:, None]
        * (0.55 * daily * (1.0 + 0.4 * amp) + weekly + 0.5 * trend + 0.6 * how_comp
           + 0.7 * ar + noise),
        0.0,
    )

    all_std = np.maximum(visits.std(axis=1), 1e-6)
    _write_csv(os.path.join(path, name + ".gbst"), {
        "geo_id": geo_ids, "All_m": visits.mean(axis=1), "All_std": all_std,
    }, num_nodes)
    if groupstd_normalize:
        visits = (visits - 0.0) / all_std[:, None]

    time_strs = np.datetime_as_string(times, unit="s")
    time_strs = np.char.add(np.char.replace(time_strs, " ", "T"), "Z")
    _write_csv(os.path.join(path, name + ".dyna"), {
        "dyna_id": np.arange(num_nodes * len_time),
        "type": "state",
        "time": np.tile(time_strs, num_nodes),
        "entity_id": np.repeat(geo_ids, len_time),
        "Visits": visits.reshape(-1),
    }, num_nodes * len_time)

    weekday = (times.astype("datetime64[D]").astype(np.int64) + 3) % 7
    ext = {"ext_id": np.arange(len_time), "time": time_strs}
    ext["holiday"] = (rng.uniform(size=len_time) < 0.03).astype(float)
    ext["weekend"] = (weekday >= 5).astype(float)
    ext["temp"] = rng.normal(0, 1, len_time)
    ext["rain"] = np.maximum(rng.normal(-0.5, 1, len_time), 0)
    ext["snow"] = np.maximum(rng.normal(-1.5, 1, len_time), 0)
    ext["New_cases"] = np.zeros(len_time)
    _write_csv(os.path.join(path, name + ".ext"), ext, len_time)

    static = rng.normal(0, 1, (num_nodes, 6))
    static_cols = {"geo_id": geo_ids}
    for j, col in enumerate(["pop", "income", "poi_retail", "poi_rest", "poi_edu", "poi_rec"]):
        static_cols[col] = static[:, j]
    _write_csv(os.path.join(path, name + ".static"), static_cols, num_nodes)

    config = {
        "geo": {"including_types": ["Point"], "Point": {}},
        "rel": {"including_types": ["geo"], "geo": {"link_weight": "num"}},
        "dyna": {"including_types": ["state"], "state": {"entity_id": "geo_id", "Visits": "num"}},
        "ext": {
            "ext_id": "num", "time": "other", "holiday": "num", "weekend": "num",
            "temp": "num", "rain": "num", "snow": "num", "New_cases": "num",
        },
        "info": {
            "data_col": ["Visits"],
            "weight_col": "link_weight",
            "ext_col": ["holiday", "weekend", "temp", "rain", "snow"],
            "data_files": [name],
            "geo_file": name,
            "rel_file": name,
            "ext_file": name,
            "output_dim": 1,
            "time_intervals": 3600,
            "init_weight_inf_or_zero": "zero",
            "set_weight_link_or_dist": "dist",
            "calculate_weight_adj": False,
            "weight_adj_epsilon": 0.1,
        },
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return path
