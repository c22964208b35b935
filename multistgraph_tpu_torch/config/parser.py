"""Layered configuration with the reference's precedence.

The same first-writer-wins merge as multistgraph_tpu/config/parser.py
(ref: libcity/config/config_parser.py:14-124):

    1. explicit external args (task/model/dataset/saved_model/train + CLI args)
    2. user config file ``<config_file>.json`` in the run directory
    3. task registry bindings (dataset_class / executor / evaluator)
    4. per-module defaults: model -> data -> executor -> evaluator
    5. dataset ``config.json`` (its ``info`` block is flattened into the root)
"""

import json
import os
from typing import Any, Dict, Iterator, Optional

from multistgraph_tpu_torch.config import defaults


class ConfigError(ValueError):
    pass


def _merge_missing(config: Dict[str, Any], extra: Dict[str, Any]) -> None:
    """First-writer-wins merge: only keys absent from `config` are added."""
    for key, value in extra.items():
        if key not in config:
            config[key] = value


class Config:
    """Dict-like config object (get/[]/in/iter), mirroring the reference API."""

    def __init__(self, config: Dict[str, Any]):
        self._config = config

    def get(self, key: str, default: Any = None) -> Any:
        return self._config.get(key, default)

    def __getitem__(self, key: str) -> Any:
        if key not in self._config:
            raise KeyError("{} is not in the config".format(key))
        return self._config[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._config[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._config

    def __iter__(self) -> Iterator[str]:
        return iter(self._config)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._config)


def load_config(
    task: str,
    model: str,
    dataset: str,
    config_file: Optional[str] = None,
    saved_model: bool = True,
    train: bool = True,
    other_args: Optional[Dict[str, Any]] = None,
    data_dir: str = "./raw_data",
    run_dir: str = ".",
) -> Config:
    """Build the merged run configuration; `data_dir` holds the dataset folders."""
    if task is None:
        raise ConfigError("the parameter task should not be None!")
    if model is None:
        raise ConfigError("the parameter model should not be None!")
    if dataset is None:
        raise ConfigError("the parameter dataset should not be None!")

    config: Dict[str, Any] = {
        "task": task,
        "model": model,
        "dataset": dataset,
        "saved_model": saved_model,
        "train": train,
    }
    if other_args:
        _merge_missing(config, other_args)

    if config_file is not None:
        path = os.path.join(run_dir, "{}.json".format(config_file))
        if not os.path.exists(path):
            raise FileNotFoundError(
                "Config file {}.json is not found. Please ensure the config "
                "file is in the run dir and is a JSON file.".format(config_file)
            )
        with open(path, "r") as f:
            _merge_missing(config, json.load(f))

    if task not in defaults.TASK_CONFIG:
        raise ConfigError("task {} is not supported.".format(task))
    task_config = defaults.TASK_CONFIG[task]
    if model not in task_config["allowed_model"]:
        raise ConfigError("task {} do not support model {}".format(task, model))
    bindings = task_config["models"][model]
    for key in ("dataset_class", "executor", "evaluator"):
        config.setdefault(key, bindings[key])

    model_key = "{}/{}".format(task, config["model"])
    for table, key in (
        (defaults.MODEL_DEFAULTS, model_key),
        (defaults.DATA_DEFAULTS, config["dataset_class"]),
        (defaults.EXECUTOR_DEFAULTS, config["executor"]),
        (defaults.EVALUATOR_DEFAULTS, config["evaluator"]),
    ):
        if key not in table:
            raise ConfigError("no default config registered for {}".format(key))
        _merge_missing(config, table[key])

    data_dir = config.get("data_dir", data_dir)
    dataset_config_path = os.path.join(data_dir, dataset, "config.json")
    if os.path.exists(dataset_config_path):
        with open(dataset_config_path, "r") as f:
            raw = json.load(f)
        for key, value in raw.items():
            if key == "info":
                _merge_missing(config, value)
            elif key not in config:
                config[key] = value

    config.setdefault("data_dir", data_dir)
    return Config(config)
