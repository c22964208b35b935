"""Determinism controls (counterpart of multistgraph_tpu/utils/seeds.py,
ref: libcity/utils/utils.py:243-254).

``set_random_seed`` seeds Python's, numpy's and torch's global generators
(host-side shuffling and synthetic data). Stochastic ops of the port draw
from explicit ``torch.Generator``s instead: model init from one seeded by
``config['seed']``, dropout from one the executor owns.
"""

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
