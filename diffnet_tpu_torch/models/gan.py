"""The legacy generator and discriminator zoo (port of
``diffnet_tpu/models/gan.py``): ``FCGenerator``, ``ResidualFCGenerator``,
``LatentGenerator`` (a latent vector -> Dense -> a 4x4 seed -> residual
upsampling blocks -> a sigmoid image) and ``Discriminator`` (residual
mean-pool downsampling -> a scalar critic), with GroupNorm where the
reference had BatchNorm.

As the port's other networks (:mod:`.networks`): channels-last at the
interface, channels-first inside; the input widths are given where flax
infers them (``in_features``, ``in_size``); flax's initializers, GroupNorm
epsilon 1e-6 and "SAME" padding; submodules under flax's names, so
:func:`~diffnet_tpu_torch.interop.params_from_jax` carries a flax tree
across.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .networks import (_conv, _dense, _generator, _group_norm, _nhwc_in,
                       _nhwc_out, _same)

__all__ = ["FCGenerator", "ResidualFCGenerator", "LatentGenerator",
           "Discriminator"]


class FCGenerator(nn.Module):
    """Four ReLU Dense layers -> a sigmoid image vector:
    ``[B, ...] -> [B, output_dim]`` (the input flattened, ``in_features``
    wide)."""

    def __init__(self, in_features, output_dim=64 * 64, fc_dim=512, seed=0):
        super().__init__()
        g = _generator(seed)
        widths = [in_features] + [fc_dim] * 4 + [output_dim]
        for i in range(5):
            self.add_module(f"Dense_{i}", _dense(widths[i], widths[i + 1], g))

    def forward(self, x, train: bool = False):
        h = x.reshape(x.shape[0], -1)
        for i in range(4):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        return torch.sigmoid(self.Dense_4(h))


class _ResFC(nn.Module):
    """GroupNorm(1) + ReLU + Dense, twice, plus the input (through a Dense
    where the widths differ)."""

    def __init__(self, in_features, features, g):
        super().__init__()
        # the shortcut Dense, where there is one, is Dense_0 (made first)
        i = int(in_features != features)
        if i:
            self.Dense_0 = _dense(in_features, features, g)
        self.GroupNorm_0 = _group_norm(1, in_features)
        self.add_module(f"Dense_{i}", _dense(in_features, features, g))
        self.GroupNorm_1 = _group_norm(1, features)
        self.add_module(f"Dense_{i + 1}", _dense(features, features, g))
        self._first = i

    def forward(self, x):
        short = self.Dense_0(x) if self._first else x
        h = getattr(self, f"Dense_{self._first}")(
            F.relu(self.GroupNorm_0(x)))
        h = getattr(self, f"Dense_{self._first + 1}")(
            F.relu(self.GroupNorm_1(h)))
        return h + short


class ResidualFCGenerator(nn.Module):
    """Four residual Dense blocks -> a sigmoid image vector."""

    def __init__(self, in_features, output_dim=64 * 64, fc_dim=512, seed=0):
        super().__init__()
        g = _generator(seed)
        for i in range(4):
            self.add_module(f"_ResFC_{i}", _ResFC(
                in_features if i == 0 else fc_dim, fc_dim, g))
        self.Dense_0 = _dense(fc_dim, output_dim, g)

    def forward(self, x, train: bool = False):
        h = x.reshape(x.shape[0], -1)
        for i in range(4):
            h = getattr(self, f"_ResFC_{i}")(h)
        return torch.sigmoid(self.Dense_0(h))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _ResUp(nn.Module):
    """Nearest x2 upsampling: a 1x1 conv of the upsampled input, plus
    GroupNorm + ReLU, upsample, a k x k conv, GroupNorm + ReLU, a k x k
    conv; channels first."""

    def __init__(self, in_channels, features, g, kernel=5):
        super().__init__()
        self.Conv_0 = _conv(in_channels, features, 1, g)
        self.GroupNorm_0 = _group_norm(math.gcd(8, in_channels), in_channels)
        self.Conv_1 = _same(in_channels, features, kernel, g)
        self.GroupNorm_1 = _group_norm(math.gcd(8, features), features)
        self.Conv_2 = _same(features, features, kernel, g)

    def forward(self, x):
        short = self.Conv_0(_up2(x))
        h = _up2(F.relu(self.GroupNorm_0(x)))
        h = self.Conv_1(h)
        h = self.Conv_2(F.relu(self.GroupNorm_1(h)))
        return h + short


class _ResDown(nn.Module):
    """Mean-pool x2 downsampling: a pooled 1x1 conv of the input, plus
    ReLU, a k x k conv, ReLU, a k x k conv, pooled; channels first."""

    def __init__(self, in_channels, features, g, kernel=3):
        super().__init__()
        self.Conv_0 = _conv(in_channels, features, 1, g)
        self.Conv_1 = _same(in_channels, features, kernel, g)
        self.Conv_2 = _same(features, features, kernel, g)

    def forward(self, x):
        short = F.avg_pool2d(self.Conv_0(x), 2)
        h = self.Conv_1(F.relu(x))
        h = self.Conv_2(F.relu(h))
        return F.avg_pool2d(h, 2) + short


class LatentGenerator(nn.Module):
    """A latent (or flattened) input -> Dense -> a 4x4 seed -> residual
    upsampling to ``out_size`` -> a sigmoid image:
    ``[B, ...] -> [B, out_size, out_size, 1]``."""

    def __init__(self, in_features, out_size=64, dim=32, seed=0):
        super().__init__()
        if out_size < 4 or out_size & (out_size - 1):
            raise ValueError(
                f"out_size must be a power of two >= 4, got {out_size} "
                "(the generator doubles resolution from a 4x4 seed)")
        g = _generator(seed)
        d = dim
        self.dim = d
        self.Dense_0 = _dense(in_features, 8 * d * 4 * 4, g)
        n_up = int(math.log2(out_size // 4))
        tail = [4 * d, 2 * d, d][-min(3, n_up):] if n_up else []
        feats = [8 * d] * max(0, n_up - 3) + tail
        cin = 8 * d
        for i, f in enumerate(feats):
            self.add_module(f"_ResUp_{i}", _ResUp(cin, f, g))
            cin = f
        self.n_up = len(feats)
        self.GroupNorm_0 = _group_norm(math.gcd(8, cin), cin)
        self.Conv_0 = _same(cin, 1, 3, g)

    def forward(self, x, train: bool = False):
        b = x.shape[0]
        h = self.Dense_0(x.reshape(b, -1)).reshape(b, 4, 4, 8 * self.dim)
        h = _nhwc_in(h)
        for i in range(self.n_up):
            h = getattr(self, f"_ResUp_{i}")(h)
        h = self.Conv_0(F.relu(self.GroupNorm_0(h)))
        return _nhwc_out(torch.sigmoid(h))


class Discriminator(nn.Module):
    """Residual mean-pool downsampling -> a scalar critic:
    ``[B, H, W(, C)] -> [B]`` for ``in_size`` = (H, W), each divisible by
    16."""

    def __init__(self, in_size, in_channels=1, dim=64, seed=0):
        super().__init__()
        g = _generator(seed)
        d = dim
        self.Conv_0 = _same(in_channels, d, 3, g)
        cin = d
        for i, f in enumerate((2 * d, 4 * d, 8 * d, 8 * d)):
            self.add_module(f"_ResDown_{i}", _ResDown(cin, f, g))
            cin = f
        H, W = in_size
        self.Dense_0 = _dense((H // 16) * (W // 16) * cin, 1, g)

    def forward(self, x, train: bool = False):
        if x.ndim == 3:
            x = x[..., None]
        h = self.Conv_0(_nhwc_in(x))
        for i in range(4):
            h = getattr(self, f"_ResDown_{i}")(h)
        # flatten channels last, as the flax Dense sees it
        return self.Dense_0(_nhwc_out(h).reshape(x.shape[0], -1))[:, 0]
