"""Per-horizon metric accumulation and result artifacts.

Counterpart of multistgraph_tpu/evaluator/evaluator.py (ref:
libcity/evaluator/traffic_state_evaluator.py:11-174). The metric math is
ops/losses.py on CPU f32 tensors; accumulation and artifacts are host-side.
Without pandas, the tables are column dicts ({metric: [value per horizon]})
and the CSVs are written with the ``csv`` module in the layout the JAX
package's DataFrames write.
"""

import csv
import datetime
import json
import os
from typing import Dict, List

import numpy as np

from multistgraph_tpu_torch.ops import losses
from multistgraph_tpu_torch.utils import ensure_dir, get_logger

ALLOWED_METRICS = [
    "MAE", "MSE", "RMSE", "MAPE",
    "masked_MAE", "masked_MSE", "masked_RMSE", "masked_MAPE",
    "R2", "EVAR",
]

NAN = float("nan")


def _metric_value(metric: str, y_pred, y_true, min_s: float) -> float:
    if metric == "masked_MAE":
        return float(losses.masked_mae(y_pred, y_true, 0.0, min_s=min_s))
    if metric == "masked_MSE":
        return float(losses.masked_mse(y_pred, y_true, 0.0, min_s=min_s))
    if metric == "masked_RMSE":
        return float(losses.masked_rmse(y_pred, y_true, 0.0, min_s=min_s))
    if metric == "masked_MAPE":
        return float(losses.masked_mape(y_pred, y_true, 0.0, min_s=min_s))
    if metric == "MAE":
        return float(losses.masked_mae(y_pred, y_true, NAN))
    if metric == "MSE":
        return float(losses.masked_mse(y_pred, y_true, NAN))
    if metric == "RMSE":
        return float(losses.masked_rmse(y_pred, y_true, NAN))
    if metric == "MAPE":
        return float(losses.masked_mape(y_pred, y_true, NAN))
    if metric == "R2":
        return float(losses.r2_score(y_pred, y_true))
    if metric == "EVAR":
        return float(losses.explained_variance_score(y_pred, y_true))
    raise ValueError(metric)


def _horizon_slices(y_pred, y_true, mode: str):
    """(pred_i, true_i) for i = 1..Tout: step i ('single') or steps 1..i ('average')."""
    mode = mode.lower()
    if mode not in ("single", "average"):
        raise ValueError("Error parameter evaluator_mode={}, please set `single` or `average`.".format(mode))
    for i in range(1, int(y_true.shape[1]) + 1):
        if mode == "average":
            yield y_pred[:, :i], y_true[:, :i]
        else:
            yield y_pred[:, i - 1], y_true[:, i - 1]


def write_csv(path: str, header: List[str], rows: List[list]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


class TrafficStateEvaluator:
    def __init__(self, config):
        self.metrics = config.get("metrics", ["MAE"])
        self.save_modes = config.get("save_mode", ["csv", "json"])
        self.mode = config.get("evaluator_mode", "single")
        self.config = config
        self.min_s = config.get("min_s", 1e-4)
        self.len_timeslots = 0
        self.result: Dict[str, float] = {}
        self.intermediate_result: Dict[str, list] = {}
        self._check_config()
        self._logger = get_logger(name="multistgraph_tpu_torch.evaluator")

    def _check_config(self):
        if not isinstance(self.metrics, list):
            raise TypeError("Evaluator type is not list")
        for metric in self.metrics:
            if metric not in ALLOWED_METRICS:
                raise ValueError("the metric {} is not allowed in TrafficStateEvaluator".format(metric))

    def collect(self, batch: Dict):
        if not isinstance(batch, dict):
            raise TypeError("evaluator.collect input is not a dict of user")
        y_true = np.asarray(batch["y_true"], np.float32)
        y_pred = np.asarray(batch["y_pred"], np.float32)
        if y_true.shape != y_pred.shape:
            raise ValueError("batch['y_true'].shape is not equal to batch['y_pred'].shape")
        self.len_timeslots = int(y_true.shape[1])
        for i, (pred_i, true_i) in enumerate(_horizon_slices(y_pred, y_true, self.mode), start=1):
            for metric in self.metrics:
                self.intermediate_result.setdefault("{}@{}".format(metric, i), []).append(
                    _metric_value(metric, pred_i, true_i, self.min_s))

    def evaluate(self) -> Dict[str, float]:
        for i in range(1, self.len_timeslots + 1):
            for metric in self.metrics:
                key = "{}@{}".format(metric, i)
                self.result[key] = sum(self.intermediate_result[key]) / len(self.intermediate_result[key])
        return self.result

    def save_result(self, save_path: str, filename: str = None) -> Dict[str, list]:
        """Writes <filename>.json and/or .csv; returns {metric: [value per horizon]}."""
        self._logger.info("Note that you select the %s mode to evaluate!", self.mode)
        self.evaluate()
        ensure_dir(save_path)
        if filename is None:
            filename = "{}_{}_{}".format(datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S"),
                                         self.config.get("model", ""), self.config.get("dataset", ""))
        if "json" in self.save_modes:
            self._logger.info("Evaluate result is %s", json.dumps(self.result))
            with open(os.path.join(save_path, filename + ".json"), "w") as f:
                json.dump(self.result, f)
        table = {}
        if "csv" in self.save_modes:
            table = {m: [self.result["{}@{}".format(m, i)] for i in range(1, self.len_timeslots + 1)]
                     for m in self.metrics}
            write_csv(os.path.join(save_path, filename + ".csv"), self.metrics,
                      [list(row) for row in zip(*table.values())])
            for m in ("MAE", "masked_MAE", "masked_MAPE", "masked_RMSE"):
                if m in table:
                    self._logger.info("%s per horizon %s, mean %.6f", m,
                                      ["%.4f" % v for v in table[m]], float(np.mean(table[m])))
        return table

    def clear(self):
        self.result = {}
        self.intermediate_result = {}


def evaluate_model(y_pred, y_true, metrics, mode="single", path="metrics.csv") -> Dict[str, list]:
    """Standalone per-horizon evaluation (ref: libcity/evaluator/utils.py:81-157):
    one row per horizon step, one column per metric, written to `path` (with
    a leading index column, as the JAX package's DataFrame.to_csv writes it)."""
    y_pred = np.asarray(y_pred, np.float32)
    y_true = np.asarray(y_true, np.float32)
    if y_true.shape != y_pred.shape:
        raise ValueError("y_true.shape is not equal to y_pred.shape")
    for metric in metrics:
        if metric not in ALLOWED_METRICS:
            raise ValueError("Error parameter metric={}!".format(metric))
    rows = [[_metric_value(m, p, t, 1e-4) for m in metrics]
            for p, t in _horizon_slices(y_pred, y_true, mode)]
    if path:
        write_csv(path, [""] + list(metrics), [[i] + r for i, r in enumerate(rows)])
    return {m: [r[j] for r in rows] for j, m in enumerate(metrics)}


EVALUATOR_REGISTRY = {"TrafficStateEvaluator": TrafficStateEvaluator}


def get_evaluator(config):
    name = config.get("evaluator", "TrafficStateEvaluator")
    if name not in EVALUATOR_REGISTRY:
        raise AttributeError("evaluator {} is not registered".format(name))
    return EVALUATOR_REGISTRY[name](config)
