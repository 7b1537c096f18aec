"""Batching iterator over numpy datasets, yielding torch tensors.

Port of ``diffnet_tpu/data/loader.py::NumpyLoader`` (without sharding or
background prefetch). Datasets have ``__len__`` and ``__getitem__``
returning a tuple of channels-last numpy arrays; the loader stacks a batch
on the host and moves it to `device`. The shuffle order is the JAX
package's: ``np.random.default_rng(seed).shuffle`` of ``arange(n)`` once
per epoch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["NumpyLoader"]


class NumpyLoader:
    """Parameters: dataset; batch_size; shuffle (reshuffle every epoch);
    drop_last (drop the trailing partial batch); seed (shuffle seed);
    device (where the batches go, default the CPU)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 42,
                 device: str | torch.device | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            samples = [self.dataset[int(i)] for i in idx]
            yield tuple(
                torch.from_numpy(np.stack([s[k] for s in samples])).to(
                    self.device)
                for k in range(len(samples[0])))
