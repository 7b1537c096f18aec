"""Solution networks for the IBN path (port of part of
``diffnet_tpu/models/networks.py``): ``Down``, ``Up``, ``UNet``, ``AE``,
``VAE`` and ``GoodNetwork``.

As in the JAX package:
  * channels-last at the interface: ``[B, H, W, C]`` in and out (NCHW
    inside, cuDNN's layout);
  * the input channels are given (``in_channels``) where flax infers them;
  * kernels start as flax's ``lecun_normal`` (a normal truncated at two
    standard deviations, variance 1 / fan_in with fan_in = kh kw C_in, also
    for transpose convs), biases at zero, drawn from a ``torch.Generator``
    seeded with `seed`;
  * InstanceNorm without scale or bias, epsilon 1e-6;
  * dropout only when ``forward(..., train=True)``: ``nn.Module.training``
    (which ``Trainer.fit`` sets) does not switch it on.

Submodules carry the flax names (``Conv_0``, ``ConvTranspose_1``,
``Down_2``, ...), so :func:`diffnet_tpu_torch.interop.params_from_jax` maps
a flax parameter tree by name. A flax ``ConvTranspose(k=4, s=2, 'SAME')``
is ``conv_transpose2d(stride=2, padding=1)`` with the kernel flipped in
both spatial axes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Down", "Up", "UNet", "AE", "VAE", "GoodNetwork"]

_IN_EPS = 1e-6            # flax.linen.InstanceNorm's epsilon
_TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2


def _lecun_(weight: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=g)


def _conv(cin, cout, k, g, stride=1, padding=0, bias=True) -> nn.Conv2d:
    c = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
    _lecun_(c.weight, cin * k * k, g)
    if bias:
        nn.init.zeros_(c.bias)
    return c


def _conv_t(cin, cout, g, bias=True) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose(cout, (4, 4), strides=(2, 2), 'SAME')``."""
    c = nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=bias)
    _lecun_(c.weight, cin * 16, g)
    if bias:
        nn.init.zeros_(c.bias)
    return c


def _norm(x):
    """Instance norm over the spatial axes of NCHW `x`. Written out, since
    ``F.instance_norm`` refuses a 1x1 map (a U-Net's deepest stage at 32^2)
    where flax gives zeros."""
    var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _IN_EPS)


def _nhwc_in(x):
    return x.permute(0, 3, 1, 2)


def _nhwc_out(x):
    return x.permute(0, 2, 3, 1)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class Down(nn.Module):
    """Stride-2 4x4 conv (no bias) + InstanceNorm (optional) +
    LeakyReLU(0.2) + dropout (optional); NCHW."""

    def __init__(self, in_channels, features, g, normalize=True,
                 dropout=0.0):
        super().__init__()
        self.Conv_0 = _conv(in_channels, features, 4, g, stride=2,
                            padding=1, bias=False)
        self.normalize = normalize
        self.dropout = dropout

    def forward(self, x, train: bool = False):
        x = self.Conv_0(x)
        if self.normalize:
            x = _norm(x)
        x = F.leaky_relu(x, 0.2)
        if self.dropout:
            x = F.dropout(x, self.dropout, training=train)
        return x


class Up(nn.Module):
    """Transpose conv x2 (no bias) + InstanceNorm + ReLU + dropout
    (optional), then the skip concatenated; NCHW."""

    def __init__(self, in_channels, features, g, dropout=0.0):
        super().__init__()
        self.ConvTranspose_0 = _conv_t(in_channels, features, g, bias=False)
        self.dropout = dropout

    def forward(self, x, skip, train: bool = False):
        x = F.relu(_norm(self.ConvTranspose_0(x)))
        if self.dropout:
            x = F.dropout(x, self.dropout, training=train)
        return torch.cat([x, skip], dim=1)


class UNet(nn.Module):
    """Pix2pix-style 5-down / 4-up U-Net with a sigmoid head.
    ``[B, H, W, in_channels] -> [B, H, W, out_channels]``; H and W must be
    divisible by 32."""

    def __init__(self, in_channels=1, out_channels=1, base_filters=32,
                 final_sigmoid=True, seed=0):
        super().__init__()
        g = _generator(seed)
        f = base_filters
        self.Down_0 = Down(in_channels, f, g, normalize=False)
        self.Down_1 = Down(f, 2 * f, g)
        self.Down_2 = Down(2 * f, 4 * f, g)
        self.Down_3 = Down(4 * f, 8 * f, g, dropout=0.5)
        self.Down_4 = Down(8 * f, 8 * f, g, dropout=0.5)
        self.Up_0 = Up(8 * f, 8 * f, g, dropout=0.5)
        self.Up_1 = Up(16 * f, 4 * f, g, dropout=0.5)
        self.Up_2 = Up(8 * f, 2 * f, g)
        self.Up_3 = Up(4 * f, f, g)
        self.Conv_0 = _conv(2 * f, out_channels, 4, g)
        self.final_sigmoid = final_sigmoid

    def forward(self, x, train: bool = False):
        x = _nhwc_in(x)
        d1 = self.Down_0(x, train)
        d2 = self.Down_1(d1, train)
        d3 = self.Down_2(d2, train)
        d4 = self.Down_3(d3, train)
        d5 = self.Down_4(d4, train)
        u = self.Up_0(d5, d4, train)
        u = self.Up_1(u, d3, train)
        u = self.Up_2(u, d2, train)
        u = self.Up_3(u, d1, train)
        out = F.interpolate(u, scale_factor=2, mode="nearest")
        out = self.Conv_0(F.pad(out, (2, 1, 2, 1)))
        if self.final_sigmoid:
            out = torch.sigmoid(out)
        return _nhwc_out(out)


def _ae_widths(dims, n_downsample):
    """(encoder widths, decoder widths), the decoder's in build order."""
    enc = [dims * (min(i, 3) + 2) * 2 for i in range(n_downsample)]
    dec = [dims * (min(i, 3) + 1) * 2 for i in reversed(range(n_downsample))]
    return enc, dec


class _AEBody(nn.Module):
    """The AE's encoder stages and decoder, shared by :class:`AE` and
    :class:`VAE`. With `latent_channels` (the VAE) two 3x3 convs between
    them give (mu, logvar), and the decoder takes that many channels."""

    def _build(self, in_channels, out_channels, dims, n_downsample, g,
               latent_channels=None):
        enc, dec = _ae_widths(dims, n_downsample)
        convs = [_conv(in_channels, 2 * dims, 7, g)]
        cin = 2 * dims
        for w in enc:
            convs.append(_conv(cin, w, 4, g, stride=2, padding=1))
            cin = w
        self._n_enc = len(convs)
        mids = []
        if latent_channels:
            mids = [_conv(cin, latent_channels, 3, g, padding=1)
                    for _ in range(2)]
            cin = latent_channels
        ups = []
        for w in dec:
            ups.append(_conv_t(cin, w, g))
            cin = w
        head = [_conv(cin, out_channels, 3, g),
                _conv(out_channels, out_channels, 7, g)]
        for i, c in enumerate(convs + mids + head):
            self.add_module(f"Conv_{i}", c)
        for i, c in enumerate(ups):
            self.add_module(f"ConvTranspose_{i}", c)
        self.n_downsample = n_downsample

    def _conv_i(self, i):
        return getattr(self, f"Conv_{i}")

    def encode(self, x):
        h = self.Conv_0(F.pad(x, (3, 3, 3, 3), mode="reflect"))
        h = F.leaky_relu(_norm(h), 0.2)
        for i in range(1, self._n_enc):
            h = F.relu(_norm(self._conv_i(i)(h)))
        return h

    def decode(self, h, first_head_conv):
        for i in range(self.n_downsample):
            h = getattr(self, f"ConvTranspose_{i}")(h)
            h = F.leaky_relu(_norm(h), 0.2)
        h = F.pad(h, (4, 4, 4, 4), mode="reflect")
        h = self._conv_i(first_head_conv)(h)
        return self._conv_i(first_head_conv + 1)(h)


class AE(_AEBody):
    """Conv autoencoder: reflection-padded 7x7 stem, `n_downsample`
    stride-2 convs of growing width, a tanh, the mirrored transpose-conv
    decoder and a 3x3 + 7x7 head."""

    def __init__(self, in_channels=1, out_channels=1, dims=64,
                 n_downsample=4, seed=0):
        super().__init__()
        self._build(in_channels, out_channels, dims, n_downsample,
                    _generator(seed))

    def forward(self, x, train: bool = False):
        h = torch.tanh(self.encode(_nhwc_in(x)))
        return _nhwc_out(self.decode(h, self._n_enc))


class VAE(_AEBody):
    """Variational AE: the AE encoder, then two 3x3 convs give (mu, logvar)
    with `latent_channels`; the decoder takes mu, or with ``sample=True``
    mu + exp(logvar / 2) eps. Returns ``(out, mu, logvar)``, channels
    last."""

    def __init__(self, in_channels=1, out_channels=1, dims=64,
                 n_downsample=3, latent_channels=64, seed=0):
        super().__init__()
        self._build(in_channels, out_channels, dims, n_downsample,
                    _generator(seed), latent_channels)

    def forward(self, x, train: bool = False, sample: bool = False,
                generator: torch.Generator | None = None):
        h = self.encode(_nhwc_in(x))
        mu = self._conv_i(self._n_enc)(h)
        logvar = self._conv_i(self._n_enc + 1)(h)
        z = mu
        if sample:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps
        out = self.decode(z, self._n_enc + 2)
        return _nhwc_out(out), _nhwc_out(mu), _nhwc_out(logvar)


class GoodNetwork(nn.Module):
    """Size-adaptive U-Net for any ``in_dim`` / ``out_dim``: a bilinear
    resize (antialiased when it shrinks) to the power of two at or below
    ``in_dim``, a 3x3 stem, stride-2 stages down to ``lowest_dim`` and back
    with skips, a 3x3 conv, a bilinear resize to ``out_dim`` and a 3x3
    head with a sigmoid."""

    def __init__(self, in_dim=64, out_dim=64, in_channels=1, out_channels=1,
                 lowest_dim=4, filters=16, final_sigmoid=True, seed=0):
        super().__init__()
        if in_dim <= 8:
            raise ValueError(f"GoodNetwork needs in_dim > 8, got {in_dim}")
        g = _generator(seed)
        self.in_dim, self.out_dim = in_dim, out_dim
        self.p2 = 2 ** int(math.floor(math.log2(in_dim)))
        self.depth = int(math.log2(self.p2 // lowest_dim))
        f = filters
        self.Conv_0 = _conv(in_channels, f, 3, g, padding=1)
        widths = [f]
        for i in range(self.depth):
            w = min(f * 2 ** (i + 1), 8 * f)
            self.add_module(f"Down_{i}", Down(widths[-1], w, g,
                                              normalize=i > 0))
            widths.append(w)
        cin = widths[-1]
        for j, i in enumerate(reversed(range(self.depth))):
            w = min(f * 2 ** i, 8 * f)
            self.add_module(f"Up_{j}", Up(
                cin, w, g, dropout=0.5 if i >= self.depth - 1 else 0.0))
            cin = w + widths[i]
        self.Conv_1 = _conv(cin, f, 3, g, padding=1)
        self.Conv_2 = _conv(f, out_channels, 3, g, padding=1)
        self.final_sigmoid = final_sigmoid

    def forward(self, x, train: bool = False):
        h = _nhwc_in(x)
        if self.in_dim != self.p2:
            h = F.interpolate(h, size=(self.p2, self.p2), mode="bilinear",
                              align_corners=False, antialias=True)
        h = F.leaky_relu(self.Conv_0(h), 0.2)
        skips = []
        for i in range(self.depth):
            skips.append(h)
            h = getattr(self, f"Down_{i}")(h, train)
        for j, i in enumerate(reversed(range(self.depth))):
            h = getattr(self, f"Up_{j}")(h, skips[i], train)
        h = F.leaky_relu(self.Conv_1(h), 0.2)
        if h.shape[-2] != self.out_dim:
            h = F.interpolate(h, size=(self.out_dim, self.out_dim),
                              mode="bilinear", align_corners=False,
                              antialias=True)
        out = self.Conv_2(h)
        if self.final_sigmoid:
            out = torch.sigmoid(out)
        return _nhwc_out(out)
