"""Synthetic large-graph dataset: the 50k-1M-node SparseATGCN workloads.

Counterpart of multistgraph_tpu/data/large_graph.py. There are no atomic
files at this scale (a 1M-node hourly CSV would be billions of rows): the
graph (ops/bsr.py:random_spatial_graph; plain BSR, or the hub, tail or band
form that ``graph_split`` names) and the per-node series are synthesised in
memory from the same numpy streams as the JAX package, then windowed,
split, scaled and uploaded like any dataset. Registered as
``SyntheticLargeGraphDataset``, so ``run_model --model SparseATGCN
--dataset SYN_LARGE_* [--graph_split band]`` runs end to end.
``node_parallel`` (node-sharded splits) is not ported (ROADMAP.md A.7).
"""

from typing import Dict

import numpy as np

from multistgraph_tpu_torch.data.loader import generate_dataloaders
from multistgraph_tpu_torch.data.scalers import fit_scaler
from multistgraph_tpu_torch.data.windows import (
    chronological_split,
    gather_windows,
    sliding_window_offsets,
    sliding_window_starts,
)
from multistgraph_tpu_torch.ops.bsr import random_spatial_graph
from multistgraph_tpu_torch.utils import get_logger, resolve_device


class SyntheticLargeGraphDataset:
    """In-memory synthetic series over a spatial power-law graph, on `device`
    (CUDA unless "cpu" is asked for)."""

    def __init__(self, config, device=None):
        if config.get("node_parallel", False):
            raise NotImplementedError("node_parallel (node-sharded splits) is not ported yet: ROADMAP.md A.7")
        self.config = config
        self.device = resolve_device(device)
        self.num_nodes = config.get("num_nodes", 4096)
        self.avg_degree = config.get("avg_degree", 16)
        self.len_time = config.get("len_time", 24 * 10)
        self.input_window = config.get("input_window", 12)
        self.output_window = config.get("output_window", 3)
        self.batch_size = config.get("batch_size", 2)
        self.train_rate = config.get("train_rate", 0.7)
        self.eval_rate = config.get("eval_rate", 0.15)
        self.scaler_type = config.get("scaler", "standard")
        self.pad_with_last_sample = config.get("pad_with_last_sample", True)
        self.seed = config.get("seed", 0)
        self.output_dim = config.get("output_dim", 1)
        self._logger = get_logger(name="multistgraph_tpu_torch.data")

        self.graph_split = config.get("graph_split", None)
        self.graph, self.num_edges = random_spatial_graph(
            self.num_nodes, self.avg_degree, seed=self.seed, split=self.graph_split)
        self.scaler = None
        self.num_batches = 0
        self.feature_dim = 1

    def _series(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 1)
        n = self.graph.padded_nodes
        hours = np.arange(self.len_time)
        phase = rng.uniform(0, 2 * np.pi, n)
        base = np.maximum(rng.normal(30, 15, n), 1.0)
        amp = np.maximum(rng.normal(10, 5, n), 0.5)
        series = base[None, :] + amp[None, :] * (
            np.sin(2 * np.pi * hours[:, None] / 24 + phase[None, :])
            + 0.3 * rng.normal(size=(self.len_time, n))
        )
        series[:, self.num_nodes:] = 0.0  # padded nodes carry no signal
        return np.maximum(series, 0.0)[..., None].astype(np.float32)

    def get_data(self):
        series = self._series()
        x_off, y_off = sliding_window_offsets(self.input_window, self.output_window)
        starts = sliding_window_starts(self.len_time, self.input_window, self.output_window)
        x, y = gather_windows(series, starts, x_off, y_off)
        splits = chronological_split(x, y, self.train_rate, self.eval_rate)
        x_train, y_train = splits[0], splits[1]
        self.feature_dim = x_train.shape[-1]
        self.scaler = fit_scaler(self.scaler_type, x_train[..., :1], y_train[..., :1])
        splits = tuple(self.scaler.transform(a).astype(np.float32) for a in splits)
        loaders = generate_dataloaders(splits, self.batch_size, pad_with_last_sample=self.pad_with_last_sample,
                                       seed=self.seed, device=self.device)
        self.num_batches = loaders[0].num_batches
        self._logger.info("synthetic large graph: %d nodes (%d padded), %d edges as a %s, %d train batches",
                          self.num_nodes, self.graph.padded_nodes, self.num_edges, type(self.graph).__name__,
                          self.num_batches)
        return loaders

    def get_data_feature(self) -> Dict:
        return {
            "scaler": self.scaler,
            "bsr_graph": self.graph,
            "num_nodes": self.graph.padded_nodes,
            "feature_dim": self.feature_dim,
            "output_dim": self.output_dim,
            "ext_dim": 0,
            "num_batches": self.num_batches,
        }
