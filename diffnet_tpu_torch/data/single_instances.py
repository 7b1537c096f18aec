"""Single-instance datasets (channels-last numpy), ported from
``diffnet_tpu/data/single_instances.py``.

Each dataset returns the same sample `n_samples` times (one epoch = n
gradient steps on one instance) as ``(inputs[H, W, C], forcing[H, W, 1])``
float32, channels last: ``inputs[..., 0]`` = domain/nu, ``[..., 1]`` = bc1
(source, u := 1), ``[..., 2]`` = bc2 (sink, u := 0).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["SingleInstanceDataset", "Rectangle", "RectangleManufactured"]


def _grid(n):
    x = np.linspace(0, 1, n)
    return np.meshgrid(x, x)


class SingleInstanceDataset:
    """Base: subclasses set .domain/.bc1/.bc2 (+ extra channels via
    `extra_channels`) and .forcing."""

    n_samples = 100

    def extra_channels(self):
        return []

    def __len__(self):
        return self.n_samples

    def __getitem__(self, index):
        chans = [self.domain, self.bc1, self.bc2] + list(self.extra_channels())
        inputs = np.stack(chans, axis=-1).astype(np.float32)
        forcing = np.asarray(self.forcing, np.float32)[..., None]
        return inputs, forcing


class Rectangle(SingleInstanceDataset):
    """Unit square, source on the top row, sink on the bottom row."""

    n_samples = 6000

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n)); self.bc1[0, :] = 1
        self.bc2 = np.zeros((n, n)); self.bc2[-1, :] = 1
        self.forcing = np.zeros((n, n))


class RectangleManufactured(SingleInstanceDataset):
    """MMS: f = 2 pi^2 sin(pi x) sin(pi y), Dirichlet-0 on all four walls."""

    def __init__(self, domain_size=64):
        n = domain_size
        self.domain = np.ones((n, n))
        self.bc1 = np.zeros((n, n))
        self.bc2 = np.zeros((n, n))
        self.bc2[[0, -1], :] = 1
        self.bc2[:, [0, -1]] = 1
        self.xx, self.yy = _grid(n)
        self.forcing = 2.0 * math.pi**2 * np.sin(math.pi * self.xx) * np.sin(
            math.pi * self.yy)

    @staticmethod
    def exact(x, y):
        return np.sin(math.pi * x) * np.sin(math.pi * y)
