"""Windowing: plain sliding windows and multi-temporal-head (MTH) sampling.

Counterpart of multistgraph_tpu/data/windows.py: offset tables plus one
vectorized gather. MTH semantics (ref: mth_dataset.py:31-108): for a label
start t, X concatenates blocks of `input_window` steps sampled at three
strides — closeness, period (interval_period days), trend (interval_trend
days) — each group oldest-to-newest, groups ordered closeness|period|trend;
y = series[t : t + output_window]. Indices lacking full history are skipped.
"""

from typing import Tuple

import numpy as np


def sliding_window_offsets(input_window: int, output_window: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain windows: X covers [t-Tin+1, t], y covers [t+1, t+Tout]."""
    return np.arange(-input_window + 1, 1), np.arange(1, output_window + 1)


def sliding_window_starts(len_time: int, input_window: int, output_window: int) -> np.ndarray:
    return np.arange(input_window - 1, len_time - output_window)


def mth_offsets(
    input_window: int,
    output_window: int,
    len_closeness: int,
    len_period: int,
    len_trend: int,
    interval_period: int,
    interval_trend: int,
    points_per_hour: int = 1,
    hour_each_day: int = 24,
) -> Tuple[np.ndarray, np.ndarray]:
    """(x_offsets, y_offsets) relative to the label start t; within each group
    the farthest block comes first, groups ordered closeness, period, trend."""
    blocks = []
    period_stride = points_per_hour * interval_period * hour_each_day
    trend_stride = points_per_hour * interval_trend * hour_each_day
    for count, stride in (
        (len_closeness, input_window),
        (len_period, period_stride),
        (len_trend, trend_stride),
    ):
        for i in range(count, 0, -1):
            start = -stride * i
            blocks.append(np.arange(start, start + input_window))
    x_offsets = np.concatenate(blocks) if blocks else np.zeros(0, dtype=np.int64)
    return x_offsets, np.arange(0, output_window)


def mth_starts(len_time: int, input_window: int, x_offsets: np.ndarray) -> np.ndarray:
    """Valid label starts: every history block in range and t + input_window
    <= len_time (the reference checks input_window on the right edge)."""
    earliest = -int(x_offsets.min()) if x_offsets.size else 0
    return np.arange(earliest, len_time - input_window + 1)


def validate_mth_windows(input_window: int, output_window: int) -> None:
    if output_window > input_window:
        raise ValueError(
            "MTH windowing requires output_window ({}) <= input_window ({})".format(
                output_window, input_window))


def gather_windows(series: np.ndarray, starts: np.ndarray, x_offsets: np.ndarray,
                   y_offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """X[s] = series[s + x_offsets], y[s] = series[s + y_offsets]."""
    x = series[starts[:, None] + x_offsets[None, :]]
    y = series[starts[:, None] + y_offsets[None, :]]
    return x, y


def chronological_split(x: np.ndarray, y: np.ndarray, train_rate: float, eval_rate: float):
    """Split (x, y) chronologically into train/val/test (ref :823-834)."""
    num_samples = x.shape[0]
    num_test = round(num_samples * (1 - train_rate - eval_rate))
    num_train = round(num_samples * train_rate)
    num_val = num_samples - num_test - num_train
    x_train, y_train = x[:num_train], y[:num_train]
    x_val = x[num_train: num_train + num_val]
    y_val = y[num_train: num_train + num_val]
    x_test, y_test = x[-num_test:], y[-num_test:]
    return x_train, y_train, x_val, y_val, x_test, y_test


def pad_to_batch_multiple(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad by repeating the last sample to a full batch (ref: data/utils.py:53-62)."""
    num_padding = (batch_size - (x.shape[0] % batch_size)) % batch_size
    if num_padding:
        x = np.concatenate([x, np.repeat(x[-1:], num_padding, axis=0)], axis=0)
        y = np.concatenate([y, np.repeat(y[-1:], num_padding, axis=0)], axis=0)
    return x, y
