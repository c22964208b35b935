"""Normalization scalers (ref: libcity/utils/normalization.py:4-127).

Counterpart of multistgraph_tpu/data/scalers.py. ``transform`` and
``inverse_transform`` take numpy arrays and torch tensors alike.
"""

from dataclasses import dataclass

import numpy as np
import torch


class Scaler:
    def transform(self, data):
        raise NotImplementedError

    def inverse_transform(self, data):
        raise NotImplementedError


@dataclass(frozen=True)
class NoneScaler(Scaler):
    def transform(self, data):
        return data

    def inverse_transform(self, data):
        return data


@dataclass(frozen=True)
class NormalScaler(Scaler):
    max: float

    def transform(self, data):
        return data / self.max

    def inverse_transform(self, data):
        return data * self.max


@dataclass(frozen=True)
class StandardScaler(Scaler):
    mean: float
    std: float

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean


@dataclass(frozen=True)
class MinMax01Scaler(Scaler):
    min: float
    max: float

    def transform(self, data):
        return (data - self.min) / (self.max - self.min)

    def inverse_transform(self, data):
        return data * (self.max - self.min) + self.min


@dataclass(frozen=True)
class MinMax11Scaler(Scaler):
    min: float
    max: float

    def transform(self, data):
        return ((data - self.min) / (self.max - self.min)) * 2.0 - 1.0

    def inverse_transform(self, data):
        return ((data + 1.0) / 2.0) * (self.max - self.min) + self.min


@dataclass(frozen=True)
class LogScaler(Scaler):
    eps: float = 0.999

    def transform(self, data):
        return torch.log(data + self.eps) if torch.is_tensor(data) else np.log(data + self.eps)

    def inverse_transform(self, data):
        return torch.exp(data) - self.eps if torch.is_tensor(data) else np.exp(data) - self.eps


def fit_scaler(scaler_type: str, x_train, y_train) -> Scaler:
    """Fit on train-split numpy arrays with the reference's statistics
    (traffic_state_datatset.py:895-928): NormalScaler max over x and y,
    StandardScaler x-only mean/std, MinMax min/max over x and y."""
    if scaler_type == "normal":
        return NormalScaler(max=float(max(x_train.max(), y_train.max())))
    if scaler_type == "standard":
        return StandardScaler(mean=float(x_train.mean()), std=float(x_train.std()))
    if scaler_type == "minmax01":
        return MinMax01Scaler(min=float(min(x_train.min(), y_train.min())),
                              max=float(max(x_train.max(), y_train.max())))
    if scaler_type == "minmax11":
        return MinMax11Scaler(min=float(min(x_train.min(), y_train.min())),
                              max=float(max(x_train.max(), y_train.max())))
    if scaler_type == "log":
        return LogScaler()
    if scaler_type == "none":
        return NoneScaler()
    raise ValueError("Scaler type error!")
