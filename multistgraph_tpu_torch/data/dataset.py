"""Dataset orchestration: atomic files -> windowed splits -> device loaders.

Counterpart of multistgraph_tpu/data/dataset.py (ref:
traffic_state_datatset.py, traffic_state_point_dataset.py,
dataset_subclass/mth_dataset.py) for the point path: the same chronological
split, scaler fit on train, ``use_3tu=False`` truncation and
get_data_feature() keys. Tables the JAX package keeps as DataFrames
(``coordinate``, ``ct_visit_mstd``) are column dicts here. The split cache
is an .npz under its own file name (``torch_`` prefix), so it never
collides with the JAX package's cache. No data_parallel. The synthetic
large-graph dataset of SparseATGCN is data/large_graph.py.
"""

import os
from typing import Dict, Tuple

import numpy as np

from multistgraph_tpu_torch.data import atomic, external, windows
from multistgraph_tpu_torch.data.loader import generate_dataloaders
from multistgraph_tpu_torch.data.scalers import fit_scaler
from multistgraph_tpu_torch.utils import ensure_dir, get_logger, resolve_device


class TrafficStateDataset:
    """Point-graph traffic-state dataset with plain sliding windows."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.dataset = config.get("dataset", "")
        self.batch_size = config.get("batch_size", 64)
        self.cache_dataset = config.get("cache_dataset", True)
        self.add_static = config.get("add_static", False)
        self.groupstd = config.get("groupstd", True)
        self.pad_with_last_sample = config.get("pad_with_last_sample", True)
        self.train_rate = config.get("train_rate", 0.7)
        self.eval_rate = config.get("eval_rate", 0.1)
        self.scaler_type = config.get("scaler", "none")
        self.ext_scaler_type = config.get("ext_scaler", "none")
        self.load_external = config.get("load_external", False)
        self.load_dynamic = config.get("load_dynamic", True)
        self.normal_external = config.get("normal_external", False)
        self.add_time_in_day = config.get("add_time_in_day", False)
        self.add_day_in_week = config.get("add_day_in_week", False)
        self.input_window = config.get("input_window", 12)
        self.output_window = config.get("output_window", 12)
        self.use_3tu = config.get("use_3tu", False)
        self.output_dim = config.get("output_dim", 1)
        self.time_intervals = config.get("time_intervals", 300)
        self.seed = config.get("seed", 0)

        self.data_dir = config.get("data_dir", "./raw_data")
        self.data_path = os.path.join(self.data_dir, self.dataset)
        if not os.path.exists(self.data_path):
            raise ValueError("Dataset {} not exist! Please ensure the path '{}' exist!".format(
                self.dataset, self.data_path))
        self.weight_col = config.get("weight_col", "")
        self.data_col = config.get("data_col", "")
        self.ext_col = config.get("ext_col", "")
        self.geo_file = config.get("geo_file", self.dataset)
        self.rel_file = config.get("rel_file", self.dataset)
        self.data_files = config.get("data_files", self.dataset)
        self.ext_file = config.get("ext_file", self.dataset)
        self.init_weight_inf_or_zero = config.get("init_weight_inf_or_zero", "inf")
        self.set_weight_link_or_dist = config.get("set_weight_link_or_dist", "dist")
        self.bidir_adj_mx = config.get("bidir_adj_mx", False)
        self.calculate_weight_adj = config.get("calculate_weight_adj", False)
        self.weight_adj_epsilon = config.get("weight_adj_epsilon", 0.1)
        self.distance_inverse = config.get("distance_inverse", False)

        self.cache_file_folder = config.get("cache_dir", "./outputs/dataset_cache")
        self.cache_file_name = os.path.join(
            self.cache_file_folder, "torch_point_{}.npz".format(self._parameters_str()))
        self._logger = get_logger(name="multistgraph_tpu_torch.data")

        self.scaler = None
        self.ext_scaler = None
        self.static = None
        self.ct_visit_mstd = None
        self.coordinate = None
        self.node_profiles = None
        self.feature_dim = 0
        self.ext_dim = 0
        self.num_batches = 0

        geo_path = os.path.join(self.data_path, self.geo_file + ".geo")
        if not os.path.exists(geo_path):
            raise ValueError("Not found .geo file!")
        self.geo = atomic.load_geo(geo_path)
        self.num_nodes = self.geo.num_nodes
        rel_path = os.path.join(self.data_path, self.rel_file + ".rel")
        if os.path.exists(rel_path):
            self.adj_mx = atomic.load_rel(
                rel_path, self.geo,
                weight_col=self.weight_col,
                set_weight_link_or_dist=self.set_weight_link_or_dist,
                init_weight_inf_or_zero=self.init_weight_inf_or_zero,
                bidir_adj_mx=self.bidir_adj_mx,
                calculate_weight_adj=self.calculate_weight_adj,
                weight_adj_epsilon=self.weight_adj_epsilon,
                distance_inverse=self.distance_inverse,
            )
        else:
            self.adj_mx = np.zeros((self.num_nodes, self.num_nodes), dtype=np.float32)

    def _parameters_str(self) -> str:
        return "_".join(str(v) for v in (
            self.dataset, self.input_window, self.output_window, self.train_rate,
            self.eval_rate, self.scaler_type, self.batch_size, self.load_external,
            self.load_dynamic, self.add_time_in_day, self.add_day_in_week,
            self.pad_with_last_sample,
        ))

    # -- windowing hooks ----------------------------------------------------
    def _window_offsets(self) -> Tuple[np.ndarray, np.ndarray]:
        return windows.sliding_window_offsets(self.input_window, self.output_window)

    def _window_starts(self, len_time: int, x_offsets: np.ndarray) -> np.ndarray:
        return windows.sliding_window_starts(len_time, self.input_window, self.output_window)

    # -- generation ---------------------------------------------------------
    def _load_series(self, filename: str) -> np.ndarray:
        dyna = atomic.load_dyna(
            os.path.join(self.data_path, filename + ".dyna"), self.geo, data_col=self.data_col)
        if not self.load_external:
            return dyna.values
        ext = None
        ext_path = os.path.join(self.data_path, self.ext_file + ".ext")
        if os.path.exists(ext_path):
            ext = atomic.load_ext(ext_path, ext_col=self.ext_col)
        return external.fuse_external(
            dyna, ext,
            add_time_in_day=self.add_time_in_day,
            add_day_in_week=self.add_day_in_week,
            load_dynamic=self.load_dynamic,
        )

    def _generate_data(self) -> Tuple[np.ndarray, np.ndarray]:
        data_files = list(self.data_files) if isinstance(self.data_files, list) else [self.data_files]
        x_list, y_list = [], []
        for filename in data_files:
            series = self._load_series(filename)
            x_offsets, y_offsets = self._window_offsets()
            starts = self._window_starts(series.shape[0], x_offsets)
            if starts.size == 0:
                raise ValueError(
                    "Parameter len_closeness/len_period/len_trend is too large "
                    "for the time range of the data!")
            x, y = windows.gather_windows(series, starts, x_offsets, y_offsets)
            x_list.append(x)
            y_list.append(y)
        x = np.concatenate(x_list)
        y = np.concatenate(y_list)
        self._logger.info("Dataset created: x %s, y %s", x.shape, y.shape)
        return x, y

    def _load_or_generate_splits(self):
        keys = ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test")
        if self.cache_dataset and os.path.exists(self.cache_file_name):
            self._logger.info("Loading %s", self.cache_file_name)
            with np.load(self.cache_file_name) as blob:
                return tuple(blob[k] for k in keys)
        x, y = self._generate_data()
        splits = windows.chronological_split(x, y, self.train_rate, self.eval_rate)
        if self.cache_dataset:
            ensure_dir(self.cache_file_folder)
            np.savez_compressed(self.cache_file_name, **dict(zip(keys, splits)))
            self._logger.info("Saved at %s", self.cache_file_name)
        return splits

    def get_data(self):
        """Return (train_loader, eval_loader, test_loader) of device batches."""
        x_train, y_train, x_val, y_val, x_test, y_test = [
            np.array(a) for a in self._load_or_generate_splits()]
        if not self.use_3tu:
            x_train = x_train[:, : self.input_window]
            x_val = x_val[:, : self.input_window]
            x_test = x_test[:, : self.input_window]

        self.feature_dim = x_train.shape[-1]
        self.ext_dim = self.feature_dim - self.output_dim
        self.node_profiles = self._mean_daily_profiles(x_train)
        d = self.output_dim
        self.scaler = fit_scaler(self.scaler_type, x_train[..., :d], y_train[..., :d])
        self.ext_scaler = fit_scaler(self.ext_scaler_type, x_train[..., d:], y_train[..., d:])
        for arr in (x_train, y_train, x_val, y_val, x_test, y_test):
            arr[..., :d] = self.scaler.transform(arr[..., :d])
        if self.normal_external:
            for arr in (x_train, y_train, x_val, y_val, x_test, y_test):
                arr[..., d:] = self.ext_scaler.transform(arr[..., d:])

        if self.add_static:
            self.static = atomic.load_static(os.path.join(self.data_path, self.ext_file + ".static"))
        if self.groupstd:
            self.ct_visit_mstd = atomic.load_gbst(os.path.join(self.data_path, self.ext_file + ".gbst"))
        self.coordinate = atomic.read_csv(os.path.join(self.data_path, self.ext_file + ".geo"))

        loaders = generate_dataloaders(
            (x_train, y_train, x_val, y_val, x_test, y_test), self.batch_size,
            pad_with_last_sample=self.pad_with_last_sample, seed=self.seed, device=self.device)
        self.num_batches = loaders[0].num_batches
        return loaders

    def _mean_daily_profiles(self, x_train: np.ndarray, bins: int = 24):
        """Per-node mean daily profile of the first target channel, binned by
        the fused time-in-day column; None without a time-in-day channel."""
        d = self.output_dim
        if not self.add_time_in_day or x_train.shape[-1] <= d or not len(x_train):
            return None
        sub = x_train[:: max(1, len(x_train) // 512)]
        n = sub.shape[2]
        tod = np.clip((sub[:, :, 0, d] * bins).astype(int), 0, bins - 1).reshape(-1)
        target = sub[..., 0].reshape(-1, n)
        profiles = np.zeros((n, bins), np.float64)
        for b in range(bins):
            mask = tod == b
            if mask.any():
                profiles[:, b] = target[mask].mean(axis=0)
        return profiles.astype(np.float32)

    def get_data_feature(self) -> Dict:
        return {
            "scaler": self.scaler,
            "adj_mx": self.adj_mx,
            "ext_dim": self.ext_dim,
            "num_nodes": self.num_nodes,
            "feature_dim": self.feature_dim,
            "output_dim": self.output_dim,
            "num_batches": self.num_batches,
            "node_profiles": self.node_profiles,
        }


class TrafficStatePointDataset(TrafficStateDataset):
    """The zoo's dataset: plain sliding windows with ``use_3tu=False``
    truncation, the base class's (JAX dataset.py:272-273). Its split cache
    is the base class's ``torch_point_`` file, apart from MTHDataset's
    ``torch_mth_`` one."""


class MTHDataset(TrafficStateDataset):
    """Multi-temporal-head dataset: closeness/period/trend strided sampling."""

    def __init__(self, config, device=None):
        super().__init__(config, device)
        self.points_per_hour = 3600 // self.time_intervals
        self.len_closeness = config.get("len_closeness", 3)
        self.len_period = config.get("len_period", 4)
        self.len_trend = config.get("len_trend", 0)
        if self.len_closeness + self.len_period + self.len_trend <= 0:
            raise ValueError("len_closeness + len_period + len_trend must be positive")
        self.interval_period = config.get("interval_period", 1)
        self.interval_trend = config.get("interval_trend", 7)
        self.hour_each_day = config.get("hour_each_day", 24)
        windows.validate_mth_windows(self.input_window, self.output_window)
        self.cache_file_name = os.path.join(
            self.cache_file_folder,
            "torch_mth_{}_{}_{}_{}_{}_{}_{}.npz".format(
                self._parameters_str(), self.len_closeness, self.len_period,
                self.len_trend, self.interval_period, self.interval_trend, self.hour_each_day))

    def _window_offsets(self) -> Tuple[np.ndarray, np.ndarray]:
        return windows.mth_offsets(
            self.input_window, self.output_window,
            self.len_closeness, self.len_period, self.len_trend,
            self.interval_period, self.interval_trend,
            points_per_hour=self.points_per_hour,
            hour_each_day=self.hour_each_day,
        )

    def _window_starts(self, len_time: int, x_offsets: np.ndarray) -> np.ndarray:
        return windows.mth_starts(len_time, self.input_window, x_offsets)

    def get_data_feature(self) -> Dict:
        feature = super().get_data_feature()
        feature.update(
            static=self.static,
            ct_visit_mstd=self.ct_visit_mstd,
            coordinate=self.coordinate,
            len_closeness=self.len_closeness * self.input_window,
            len_period=self.len_period * self.input_window,
            len_trend=self.len_trend * self.input_window,
        )
        return feature


def _large_graph_dataset(config, device=None):
    from multistgraph_tpu_torch.data.large_graph import SyntheticLargeGraphDataset

    return SyntheticLargeGraphDataset(config, device)


DATASET_REGISTRY = {
    "TrafficStateDataset": TrafficStateDataset,
    "TrafficStatePointDataset": TrafficStatePointDataset,
    "MTHDataset": MTHDataset,
    "SyntheticLargeGraphDataset": _large_graph_dataset,
}


def get_dataset(config, device=None):
    """Dataset factory by config['dataset_class']."""
    name = config["dataset_class"]
    if name not in DATASET_REGISTRY:
        raise AttributeError("dataset_class is not found")
    return DATASET_REGISTRY[name](config, device)
