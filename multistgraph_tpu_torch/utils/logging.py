"""Run logging: a stdout logger (counterpart of multistgraph_tpu/utils/logging.py)."""

import logging
import os
from typing import Optional


def ensure_dir(path: str) -> None:
    if path and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


def get_logger(name: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """A logger with one stdout handler, not propagated to the root logger."""
    logger = logging.getLogger(name or "multistgraph_tpu_torch")
    logger.handlers.clear()
    logger.setLevel(level)
    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(stream)
    logger.propagate = False
    return logger
