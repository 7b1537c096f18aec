"""Point-cloud -> grid networks (port of ``diffnet_tpu/models/pointnets.py``):
the ImmDiff family and DGCNN.

As in the JAX package: clouds are channels-last ``[B, Np, C]``, grids
``[B, H, W, C]``; the k nearest neighbours come from one batched top-k;
GroupNorm (epsilon 1e-6) stands where the reference had BatchNorm. As in
:mod:`.networks`: the input sizes flax infers are given (``in_channels``,
``n_points``), weights start as flax's initializers drawn from a
``torch.Generator`` seeded with `seed`, and submodules carry the flax names
(``MLP_0/Dense_1``, ``_ParallelEncoders_0/Conv_1``, ``GroupNorm_3``, ...)
so that :func:`diffnet_tpu_torch.interop.params_from_jax` carries a flax
tree.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .networks import (_Named, _conv, _conv_t, _dense, _generator,
                       _group_norm, _lecun_, _nhwc_in, _nhwc_out, _same)

__all__ = ["MLP", "ConvNet1D", "ImmDiff", "ImmDiffVAE", "ImmDiffLarge",
           "ImmDiffLargeNormals", "EikonalLinear", "DGCNN2D", "knn_indices",
           "graph_feature"]


def _leaky(v):
    """flax's ``nn.leaky_relu`` default slope, 0.01."""
    return F.leaky_relu(v, 0.01)


class MLP(_Named):
    """Dense layers of widths `features` over the last axis, `nonlin`
    between them and `final_nonlin` (if any) after the last."""

    def __init__(self, in_features: int, features: Sequence[int],
                 nonlin: Callable = _leaky,
                 final_nonlin: Callable | None = None,
                 g: torch.Generator | None = None, seed: int = 0):
        super().__init__()
        g = g if g is not None else _generator(seed)
        cin = in_features
        for f in features:
            self._child("Dense", _dense(cin, f, g))
            cin = f
        self.n_layers = len(features)
        self.nonlin, self.final_nonlin = nonlin, final_nonlin

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = self.nonlin(x)
            elif self.final_nonlin is not None:
                x = self.final_nonlin(x)
        return x


class ConvNet1D(_Named):
    """Stride-2 1D transpose convs, one per width in `hidden_channels` and
    one of `out_channels`, each followed by `nonlin` (the last by
    `final_nonlin`): ``[B, L, in_channels] -> [B, 2^n L, out_channels]``.
    flax's "SAME" transpose conv pads the dilated input by (k - 1, 1) for
    k <= 2 and (ceil(k / 2), floor(k / 2)) beyond, so the full transpose
    conv is cropped by the rest of k - 1 on each side."""

    def __init__(self, in_channels: int, hidden_channels: Sequence[int],
                 out_channels: int = 1, kernel: int = 2,
                 nonlin: Callable = F.relu,
                 final_nonlin: Callable | None = None, seed: int = 0):
        super().__init__()
        if kernel < 2:
            raise ValueError(f"ConvNet1D needs kernel >= 2, got {kernel}")
        g = _generator(seed)
        cin = in_channels
        for c in list(hidden_channels) + [out_channels]:
            t = self._child("ConvTranspose",
                            nn.ConvTranspose1d(cin, c, kernel, stride=2))
            _lecun_(t.weight, cin * kernel, g)
            nn.init.zeros_(t.bias)
            cin = c
        pad_lo = kernel - 1 if kernel <= 2 else (kernel + 1) // 2
        self.crop = (kernel - 1 - pad_lo, pad_lo - 1)
        self.n_layers = len(hidden_channels) + 1
        self.nonlin, self.final_nonlin = nonlin, final_nonlin

    def forward(self, x):
        x = _nhwc_in(x)
        lo, hi = self.crop
        for i in range(self.n_layers):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = x[..., lo:x.shape[-1] - hi]
            if i < self.n_layers - 1:
                x = self.nonlin(x)
            elif self.final_nonlin is not None:
                x = self.final_nonlin(x)
        return _nhwc_out(x)


def _resize_bilinear(h, size):
    """``jax.image.resize(..., "bilinear")`` of channels-first `h`: half-
    pixel centres, antialiased when it shrinks (a no-op when it grows)."""
    return F.interpolate(h, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class ImmDiff(_Named):
    """The flattened cloud through an MLP (`n_hidden` layers of `hidden`,
    leaky ReLU) to a ``latent_hw``^2 image, four 4x4 "SAME" convs + leaky
    ReLU(0.2), a bilinear resize to `out_size` and a 3x3 head:
    ``[B, Np, C] -> [B, out_size, out_size, out_channels]``."""

    def __init__(self, n_points: int, in_channels: int = 2,
                 out_channels: int = 1, out_size: int = 64,
                 latent_hw: int = 32, hidden: int = 1500, n_hidden: int = 6,
                 seed: int = 0):
        super().__init__()
        g = _generator(seed)
        self._child("MLP", MLP(n_points * in_channels,
                               [hidden] * n_hidden + [latent_hw**2],
                               final_nonlin=_leaky, g=g))
        cin = 1
        for f in (16, 32, 64, 32):
            self._child("Conv", _same(cin, f, 4, g))
            cin = f
        self._child("Conv", _same(cin, out_channels, 3, g))
        self.latent_hw, self.out_size = latent_hw, out_size

    def forward(self, x, train: bool = False):
        b = x.shape[0]
        h = self.MLP_0(x.reshape(b, -1))
        h = h.reshape(b, 1, self.latent_hw, self.latent_hw)
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"Conv_{i}")(h), 0.2)
        h = _resize_bilinear(h, self.out_size)
        return _nhwc_out(self.Conv_4(h))


def _upsampling_stages(out_size: int, hw: int = 8) -> int:
    """How many x2 stages take an `hw` grid to at least `out_size`."""
    n = 0
    while hw < out_size:
        hw, n = 2 * hw, n + 1
    return n


class ImmDiffVAE(_Named):
    """The flattened cloud through a 2-layer MLP to (mu, logvar) of
    `latent_dim`; z = mu, or with ``sample=True`` mu + exp(logvar / 2) eps;
    a Dense to an 8x8x8 grid, stride-2 transpose convs of 16 + leaky
    ReLU(0.2) until `out_size`, a 3x3 head. Returns ``(out, mu,
    logvar)``."""

    def __init__(self, n_points: int, in_channels: int = 2,
                 out_channels: int = 1, out_size: int = 64,
                 latent_dim: int = 256, hidden: int = 1024, seed: int = 0):
        super().__init__()
        g = _generator(seed)
        self._child("MLP", MLP(n_points * in_channels, [hidden, hidden],
                               g=g))
        self._child("Dense", _dense(hidden, latent_dim, g))
        self._child("Dense", _dense(hidden, latent_dim, g))
        self._child("Dense", _dense(latent_dim, 8 * 8 * 8, g))
        cin = 8
        self.n_up = _upsampling_stages(out_size)
        for _ in range(self.n_up):
            self._child("ConvTranspose", _conv_t(cin, 16, g))
            cin = 16
        self._child("Conv", _same(cin, out_channels, 3, g))

    def forward(self, x, train: bool = False, sample: bool = False,
                generator: torch.Generator | None = None):
        b = x.shape[0]
        h = self.MLP_0(x.reshape(b, -1))
        mu, logvar = self.Dense_0(h), self.Dense_1(h)
        z = mu
        if sample:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps
        h = _nhwc_in(self.Dense_2(z).reshape(b, 8, 8, 8))
        for i in range(self.n_up):
            h = F.leaky_relu(getattr(self, f"ConvTranspose_{i}")(h), 0.2)
        return _nhwc_out(self.Conv_0(h)), mu, logvar


class _ParallelEncoders(_Named):
    """Four encodings of a cloud, concatenated: 2-layer MLPs of `width`
    with leaky ReLU, tanh and sin, and two 5-tap "SAME" 1D convs over the
    points (16 then 4 channels, leaky ReLU(0.2) between) flattened into a
    Dense: ``[B, Np, C] -> [B, 4 width]``."""

    def __init__(self, n_points, in_channels, g, width=512):
        super().__init__()
        flat = n_points * in_channels
        for nonlin in (_leaky, torch.tanh, torch.sin):
            self._child("MLP", MLP(flat, [width, width], nonlin=nonlin, g=g))
        self._child("Conv", _same(in_channels, 16, 5, g, ndim=1))
        self._child("Conv", _same(16, 4, 5, g, ndim=1))
        self._child("Dense", _dense(4 * n_points, width, g))

    def forward(self, x):
        b = x.shape[0]
        flat = x.reshape(b, -1)
        h = F.leaky_relu(self.Conv_0(_nhwc_in(x)), 0.2)
        h = _nhwc_out(self.Conv_1(h)).reshape(b, -1)
        return torch.cat([self.MLP_0(flat), self.MLP_1(flat),
                          self.MLP_2(flat), self.Dense_0(h)], dim=-1)


class ImmDiffLarge(_Named):
    """Four parallel encodings of the cloud, a Dense to an 8x8x16 grid,
    then stride-2 transpose convs of 32 + leaky ReLU(0.2) until
    `out_size`, each concatenated with the nearest-upsampled grid before
    it; a 3x3 head."""

    def __init__(self, n_points: int, in_channels: int = 2,
                 out_channels: int = 1, out_size: int = 64, seed: int = 0):
        super().__init__()
        g = _generator(seed)
        self._child("_ParallelEncoders",
                    _ParallelEncoders(n_points, in_channels, g))
        self._child("Dense", _dense(4 * 512, 8 * 8 * 16, g))
        cin = 16
        self.n_up = _upsampling_stages(out_size)
        for _ in range(self.n_up):
            self._child("ConvTranspose", _conv_t(cin, 32, g))
            cin += 32
        self._child("Conv", _same(cin, out_channels, 3, g))

    def forward(self, x, train: bool = False):
        b = x.shape[0]
        h = _nhwc_in(self.Dense_0(self._ParallelEncoders_0(x))
                     .reshape(b, 8, 8, 16))
        for i in range(self.n_up):
            skip = F.interpolate(h, scale_factor=2, mode="nearest")
            h = F.leaky_relu(getattr(self, f"ConvTranspose_{i}")(h), 0.2)
            h = torch.cat([h, skip], dim=1)
        return _nhwc_out(self.Conv_0(h))


class ImmDiffLargeNormals(_Named):
    """Two inputs, (points, normals), each through its own parallel
    encoders; a Dense to an 8x8x16 grid, stride-2 transpose convs of 32 +
    leaky ReLU(0.2) until `out_size`, a 3x3 head."""

    def __init__(self, n_points: int, in_channels: int = 2,
                 out_channels: int = 1, out_size: int = 64, seed: int = 0):
        super().__init__()
        g = _generator(seed)
        for _ in range(2):
            self._child("_ParallelEncoders",
                        _ParallelEncoders(n_points, in_channels, g))
        self._child("Dense", _dense(8 * 512, 8 * 8 * 16, g))
        cin = 16
        self.n_up = _upsampling_stages(out_size)
        for _ in range(self.n_up):
            self._child("ConvTranspose", _conv_t(cin, 32, g))
            cin = 32
        self._child("Conv", _same(cin, out_channels, 3, g))

    def forward(self, points, normals, train: bool = False):
        b = points.shape[0]
        code = torch.cat([self._ParallelEncoders_0(points),
                          self._ParallelEncoders_1(normals)], dim=-1)
        h = _nhwc_in(self.Dense_0(code).reshape(b, 8, 8, 16))
        for i in range(self.n_up):
            h = F.leaky_relu(getattr(self, f"ConvTranspose_{i}")(h), 0.2)
        return _nhwc_out(self.Conv_0(h))


class EikonalLinear(_Named):
    """A sin MLP over coordinates: `depth` layers of `width`, then
    `out_features`, on the last axis."""

    def __init__(self, in_features: int = 2, out_features: int = 1,
                 width: int = 256, depth: int = 4, seed: int = 0):
        super().__init__()
        self._child("MLP", MLP(in_features, [width] * depth + [out_features],
                               nonlin=torch.sin, seed=seed))

    def forward(self, x, train: bool = False):
        return self.MLP_0(x)


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest points of each point by euclidean distance (itself
    first): ``[B, Np, C] -> [B, Np, k]``. The squared distances are the
    JAX package's expression (not ``torch.cdist``), so they round alike;
    ties may be ordered otherwise than ``jax.lax.top_k`` orders them."""
    sq = torch.sum(x**2, -1)
    d2 = (sq[:, :, None] + sq[:, None, :]
          - 2.0 * torch.einsum("bnc,bmc->bnm", x, x))
    return torch.topk(-d2, k, dim=-1).indices


def graph_feature(x: torch.Tensor, k: int, idx=None) -> torch.Tensor:
    """Edge features ``[x_j - x_i, x_i]`` for each of the k neighbours j of
    each point i: ``[B, Np, C] -> [B, Np, k, 2C]``."""
    if idx is None:
        idx = knn_indices(x, k)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    gathered = x[b, idx]                              # [B, Np, k, C]
    center = x[:, :, None, :].expand_as(gathered)
    return torch.cat([gathered - center, center], dim=-1)


class DGCNN2D(_Named):
    """Dynamic-graph CNN: three edge convs (16, 32, 64; a 1x1 conv on the k
    edge features, GroupNorm, leaky ReLU(0.2), max over the neighbours),
    a Dense of 128 + GroupNorm + leaky ReLU over their concatenation, a
    max over each half of the points, Dense 256 and lowest_size^2 with
    ReLU, the two halves as the channels of a lowest_size^2 grid, stride-2
    transpose convs (2 channels + leaky ReLU) to domain_size / 2 and one
    of 1 channel: ``[B, Np, in_channels] -> [B, domain_size, domain_size,
    1]``."""

    def __init__(self, in_channels: int = 2, domain_size: int = 32,
                 k: int = 20, lowest_size: int = 16, seed: int = 0):
        super().__init__()
        g = _generator(seed)
        cin = in_channels
        for feats in (16, 32, 64):
            self._child("Conv", _conv(2 * cin, feats, 1, g, bias=False))
            self._child("GroupNorm", _group_norm(min(4, feats), feats))
            cin = feats
        self._child("Dense", _dense(16 + 32 + 64, 128, g))
        self._child("GroupNorm", _group_norm(4, 128))
        self._child("Dense", _dense(128, 256, g))
        self._child("Dense", _dense(256, lowest_size**2, g))
        self.n_up = _upsampling_stages(domain_size // 2, lowest_size)
        for _ in range(self.n_up):
            self._child("ConvTranspose", _conv_t(2, 2, g))
        self._child("ConvTranspose", _conv_t(2, 1, g))
        self.k, self.lowest_size = k, lowest_size

    def _edge_conv(self, h, i):
        e = graph_feature(h, min(self.k, h.shape[1] - 1))
        e = getattr(self, f"Conv_{i}")(e.permute(0, 3, 1, 2))
        e = F.leaky_relu(getattr(self, f"GroupNorm_{i}")(e), 0.2)
        return e.amax(dim=3).transpose(1, 2)          # [B, Np, feats]

    def forward(self, x, train: bool = False):
        b = x.shape[0]
        x1 = self._edge_conv(x, 0)
        x2 = self._edge_conv(x1, 1)
        x3 = self._edge_conv(x2, 2)
        h = self.Dense_0(torch.cat([x1, x2, x3], dim=-1))   # [B, Np, 128]
        h = F.leaky_relu(self.GroupNorm_3(h.transpose(1, 2)), 0.2)
        half = h.shape[2] // 2
        pooled = torch.stack([h[..., :half].amax(2), h[..., half:].amax(2)],
                             dim=1)                           # [B, 2, 128]
        h = F.relu(self.Dense_2(F.relu(self.Dense_1(pooled))))
        s = self.lowest_size
        h = _nhwc_in(h.transpose(1, 2).reshape(b, s, s, 2))
        for i in range(self.n_up):
            h = F.leaky_relu(getattr(self, f"ConvTranspose_{i}")(h), 0.2)
        return _nhwc_out(getattr(self, f"ConvTranspose_{self.n_up}")(h))
