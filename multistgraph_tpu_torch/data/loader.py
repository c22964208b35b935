"""Device-resident batch iteration.

Counterpart of multistgraph_tpu/data/loader.py: each split is uploaded to
the device once as float32 tensors, and a batch is an ``index_select`` of a
host-permuted index slice. Same padding (repeat the last sample to a full
batch), same ragged-tail drop without padding, and the same numpy
permutation stream for the same seed. No sharding.
"""

from typing import Dict, Iterator

import numpy as np
import torch

from multistgraph_tpu_torch.data.windows import pad_to_batch_multiple


class DeviceDataLoader:
    """Iterates dict batches {'X': (B,...), 'y': (B,...)} of device tensors."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, shuffle: bool,
                 pad_with_last_sample: bool = True, seed: int = 0, device="cpu"):
        if pad_with_last_sample:
            x, y = pad_to_batch_multiple(x, y, batch_size)
        if x.shape[0] % batch_size != 0:
            keep = (x.shape[0] // batch_size) * batch_size
            x, y = x[:keep], y[:keep]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
        self.y = torch.as_tensor(np.asarray(y, np.float32)).to(device)
        self.num_samples = int(self.x.shape[0])
        self.num_batches = self.num_samples // batch_size

    def __len__(self) -> int:
        return self.num_batches

    def epoch_permutation(self) -> np.ndarray:
        """(num_batches, B) sample indices for one epoch, shuffled if enabled."""
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        return order[: self.num_batches * self.batch_size].reshape(self.num_batches, self.batch_size)

    def ordered_permutation(self) -> np.ndarray:
        """(num_batches, B) sample indices in dataset order (eval/test)."""
        return np.arange(self.num_batches * self.batch_size).reshape(self.num_batches, self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for idx in self.epoch_permutation():
            idx = torch.as_tensor(idx, device=self.x.device)
            yield {"X": self.x.index_select(0, idx), "y": self.y.index_select(0, idx)}


def generate_dataloaders(splits, batch_size: int, pad_with_last_sample: bool = True,
                         seed: int = 0, device="cpu"):
    """(train, eval, test) loaders; train/eval shuffled, test not."""
    x_train, y_train, x_val, y_val, x_test, y_test = splits
    train = DeviceDataLoader(x_train, y_train, batch_size, True, pad_with_last_sample, seed, device)
    val = DeviceDataLoader(x_val, y_val, batch_size, True, pad_with_last_sample, seed + 1, device)
    test = DeviceDataLoader(x_test, y_test, batch_size, False, pad_with_last_sample, seed + 2, device)
    return train, val, test
