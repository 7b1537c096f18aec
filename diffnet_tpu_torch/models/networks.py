"""Solution networks (port of ``diffnet_tpu/models/networks.py``):
``Down``, ``Up``, ``UNet``, ``UNet3D``, ``MultiOutUNet``, ``AE``, ``VAE``,
``GoodNetwork``, ``UNetRes``, ``ImplicitConv``, ``ResNetED`` and
``LocalConv2d``.

As in the JAX package:
  * channels-last at the interface: ``[B, H, W, C]`` (``[B, D, H, W, C]``
    for ``UNet3D``) in and out (channels-first inside, cuDNN's layout);
  * the input channels are given (``in_channels``) where flax infers them;
  * kernels start as flax's ``lecun_normal`` (a normal truncated at two
    standard deviations, variance 1 / fan_in with fan_in = prod(k) C_in,
    also for transpose convs), biases at zero, GroupNorm scales at one,
    drawn from a ``torch.Generator`` seeded with `seed`;
  * InstanceNorm without scale or bias, GroupNorm with both, epsilon 1e-6
    (torch's default is 1e-5);
  * "SAME" padding as XLA pads: (k - 1) // 2 before and the rest after, so
    an even kernel pads (1, 2), and a dilated 3x3 pads by its dilation;
  * dropout only when ``forward(..., train=True)``: ``nn.Module.training``
    (which ``Trainer.fit`` sets) does not switch it on.

Submodules carry the flax names (``Conv_0``, ``ConvTranspose_1``,
``Down_2``, ``_GatedResBlock_1/GroupNorm_0``, ...), so
:func:`diffnet_tpu_torch.interop.params_from_jax` maps a flax parameter
tree by name. A flax ``ConvTranspose(k=4, s=2, 'SAME')`` is
``conv_transpose(stride=2, padding=1)`` with the kernel flipped in every
spatial axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Down", "Up", "UNet", "UNet3D", "MultiOutUNet", "AE", "VAE",
           "GoodNetwork", "UNetRes", "ImplicitConv", "ResNetED",
           "LocalConv2d"]

_EPS = 1e-6               # flax.linen.InstanceNorm's and GroupNorm's epsilon
_TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2
_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {1: nn.ConvTranspose1d, 2: nn.ConvTranspose2d,
           3: nn.ConvTranspose3d}


def _lecun_(weight: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=g)


def _same_pads(k: int, dilation: int = 1) -> tuple[int, int]:
    """XLA's "SAME" padding of a stride-1 axis: (before, after)."""
    total = (k - 1) * dilation
    return total // 2, total - total // 2


class _PaddedConv2d(nn.Conv2d):
    """A 2D conv that pads its input by ``same_pad`` (F.pad order) first:
    flax's "SAME" for an even kernel, which XLA pads (1, 2)."""

    same_pad: tuple[int, int, int, int]

    def forward(self, x):
        return super().forward(F.pad(x, self.same_pad))


def _conv(cin, cout, k, g, stride=1, padding=0, bias=True, ndim=2,
          dilation=1):
    c = _CONV[ndim](cin, cout, k, stride=stride, padding=padding, bias=bias,
                    dilation=dilation)
    _lecun_(c.weight, cin * k**ndim, g)
    if bias:
        nn.init.zeros_(c.bias)
    return c


def _same(cin, cout, k, g, bias=True, ndim=2, dilation=1):
    """flax ``Conv(cout, (k,) * ndim, padding="SAME")``, stride 1."""
    lo, hi = _same_pads(k, dilation)
    if lo == hi:
        return _conv(cin, cout, k, g, padding=lo, bias=bias, ndim=ndim,
                     dilation=dilation)
    if ndim != 2:
        raise ValueError(f"an even {ndim}D 'SAME' conv is not ported")
    c = _PaddedConv2d(cin, cout, k, bias=bias, dilation=dilation)
    c.same_pad = (lo, hi, lo, hi)
    _lecun_(c.weight, cin * k * k, g)
    if bias:
        nn.init.zeros_(c.bias)
    return c


def _conv_t(cin, cout, g, bias=True, ndim=2):
    """flax ``ConvTranspose(cout, (4,) * ndim, strides=2, 'SAME')``."""
    c = _CONV_T[ndim](cin, cout, 4, stride=2, padding=1, bias=bias)
    _lecun_(c.weight, cin * 4**ndim, g)
    if bias:
        nn.init.zeros_(c.bias)
    return c


def _dense(cin, cout, g) -> nn.Linear:
    """flax ``Dense(cout)``: lecun_normal kernel, zero bias."""
    d = nn.Linear(cin, cout)
    _lecun_(d.weight, cin, g)
    nn.init.zeros_(d.bias)
    return d


def _group_norm(groups, channels) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=_EPS)


def _norm(x):
    """Instance norm over the spatial axes of channels-first `x`. Written
    out, since ``F.instance_norm`` refuses a 1-node map (a U-Net's deepest
    stage at 32^2 or 32^3) where flax gives zeros."""
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.ndim)), correction=0,
                               keepdim=True)
    return (x - mean) * torch.rsqrt(var + _EPS)


def _nhwc_in(x):
    return x.movedim(-1, 1)


def _nhwc_out(x):
    return x.movedim(1, -1)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class _Named(nn.Module):
    """Adds submodules under flax's names: the kind and its count so far
    (``Conv_0``, ``Conv_1``, ``GroupNorm_0``, ...)."""

    def _child(self, kind: str, module: nn.Module) -> nn.Module:
        counts = self.__dict__.setdefault("_kind_counts", {})
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return module


class Down(nn.Module):
    """Stride-2 4^ndim conv (no bias) + InstanceNorm (optional) +
    LeakyReLU(0.2) + dropout (optional); channels first."""

    def __init__(self, in_channels, features, g, normalize=True,
                 dropout=0.0, ndim=2):
        super().__init__()
        self.Conv_0 = _conv(in_channels, features, 4, g, stride=2,
                            padding=1, bias=False, ndim=ndim)
        self.normalize = normalize
        self.dropout = dropout

    def forward(self, x, train: bool = False):
        if min(x.shape[2:]) < 2:
            # flax pads (1, 1): an axis of one node gives an empty map
            # (an 8-node side reaches the fifth Down of a U-Net at 16)
            return x.new_zeros(x.shape[:1] + (self.Conv_0.out_channels,)
                               + tuple(max(0, (s - 2) // 2 + 1)
                                       for s in x.shape[2:]))
        x = self.Conv_0(x)
        if self.normalize:
            x = _norm(x)
        x = F.leaky_relu(x, 0.2)
        if self.dropout:
            x = F.dropout(x, self.dropout, training=train)
        return x


class Up(nn.Module):
    """Transpose conv x2 (no bias) + InstanceNorm + ReLU + dropout
    (optional), then the skip concatenated; channels first."""

    def __init__(self, in_channels, features, g, dropout=0.0, ndim=2):
        super().__init__()
        self.ConvTranspose_0 = _conv_t(in_channels, features, g, bias=False,
                                       ndim=ndim)
        self.dropout = dropout

    def forward(self, x, skip, train: bool = False):
        if x.numel() == 0:
            # flax's transposed conv of an empty map: zeros, one node on
            # an axis of none
            x = x.new_zeros(x.shape[:1] + (self.ConvTranspose_0.out_channels,)
                            + tuple(2 * s or 1 for s in x.shape[2:]))
        else:
            x = self.ConvTranspose_0(x)
        x = F.relu(_norm(x))
        if self.dropout:
            x = F.dropout(x, self.dropout, training=train)
        return torch.cat([x, skip], dim=1)


def _encoder(net, in_channels, f, g, ndim):
    """The pix2pix U-Net's five Down stages, as ``Down_0`` ... ``Down_4``."""
    for cin, cout, kw in ((in_channels, f, {"normalize": False}),
                          (f, 2 * f, {}), (2 * f, 4 * f, {}),
                          (4 * f, 8 * f, {"dropout": 0.5}),
                          (8 * f, 8 * f, {"dropout": 0.5})):
        net._child("Down", Down(cin, cout, g, ndim=ndim, **kw))


def _decoder(net, out_channels, f, g, ndim):
    """One pix2pix decoder: four Up stages and the 4^ndim head conv, as the
    next ``Up_*`` and ``Conv_*``; returns them."""
    ups = [net._child("Up", Up(cin, cout, g, ndim=ndim, **kw)) for
           cin, cout, kw in ((8 * f, 8 * f, {"dropout": 0.5}),
                             (16 * f, 4 * f, {"dropout": 0.5}),
                             (8 * f, 2 * f, {}), (4 * f, f, {}))]
    return tuple(ups), net._child("Conv", _conv(2 * f, out_channels, 4, g,
                                                ndim=ndim))


def _encode(net, x, train):
    skips = []
    for i in range(5):
        x = getattr(net, f"Down_{i}")(x, train)
        skips.append(x)
    return skips


def _decode(skips, ups, head, ndim, final_sigmoid, train):
    u = skips[4]
    for up, skip in zip(ups, skips[3::-1]):
        u = up(u, skip, train)
    out = F.interpolate(u, scale_factor=2, mode="nearest")
    out = head(F.pad(out, (2, 1) * ndim))
    return torch.sigmoid(out) if final_sigmoid else out


class UNet(_Named):
    """Pix2pix-style 5-down / 4-up U-Net with a sigmoid head.
    ``[B, H, W, in_channels] -> [B, H, W, out_channels]``; H and W must be
    divisible by 32."""

    ndim = 2

    def __init__(self, in_channels=1, out_channels=1, base_filters=32,
                 final_sigmoid=True, seed=0):
        super().__init__()
        g = _generator(seed)
        _encoder(self, in_channels, base_filters, g, self.ndim)
        # a tuple, which nn.Module does not register a second time
        self._decoder = _decoder(self, out_channels, base_filters, g,
                                 self.ndim)
        self.final_sigmoid = final_sigmoid

    def forward(self, x, train: bool = False):
        skips = _encode(self, _nhwc_in(x), train)
        ups, head = self._decoder
        return _nhwc_out(_decode(skips, ups, head, self.ndim,
                                 self.final_sigmoid, train))


class UNet3D(UNet):
    """The U-Net in 3D: ``[B, D, H, W, in_channels] -> [B, D, H, W,
    out_channels]``; every side divisible by 32."""

    ndim = 3

    def __init__(self, in_channels=1, out_channels=1, base_filters=16,
                 final_sigmoid=True, seed=0):
        super().__init__(in_channels, out_channels, base_filters,
                         final_sigmoid, seed)


class MultiOutUNet(_Named):
    """The U-Net's encoder shared by `num_outputs` independent decoders
    (e.g. u, v, p): returns a tuple of ``[B, H, W, out_channels]``."""

    def __init__(self, in_channels=1, num_outputs=3, out_channels=1,
                 base_filters=32, final_sigmoid=False, seed=0):
        super().__init__()
        g = _generator(seed)
        _encoder(self, in_channels, base_filters, g, 2)
        self._heads = [_decoder(self, out_channels, base_filters, g, 2)
                       for _ in range(num_outputs)]
        self.final_sigmoid = final_sigmoid

    def forward(self, x, train: bool = False):
        skips = _encode(self, _nhwc_in(x), train)
        return tuple(_nhwc_out(_decode(skips, ups, head, 2,
                                       self.final_sigmoid, train))
                     for ups, head in self._heads)


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


class _GatedResBlock(nn.Module):
    """Two 3x3 "SAME" convs (dilated by `dilation`) of width `features`, or
    twice that gated by a sigmoid of its second half, GroupNorm + ReLU
    (+ dropout) between them; the input added, then GroupNorm + ReLU."""

    def __init__(self, features, g, gated=True, dilation=1, dropout=0.2):
        super().__init__()
        hidden = 2 * features if gated else features
        self.Conv_0 = _same(features, hidden, 3, g, dilation=dilation)
        self.GroupNorm_0 = _group_norm(math.gcd(8, hidden), hidden)
        self.Conv_1 = _same(hidden, hidden, 3, g, dilation=dilation)
        self.GroupNorm_1 = _group_norm(math.gcd(8, features), features)
        self.gated = gated
        self.dropout = dropout

    def forward(self, x, train: bool = False):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        if self.dropout:
            h = F.dropout(h, self.dropout, training=train)
        h = self.Conv_1(h)
        if self.gated:
            a, b = torch.chunk(h, 2, dim=1)
            h = a * torch.sigmoid(b)
        return F.relu(self.GroupNorm_1(x + h))


class UNetRes(_Named):
    """Residual U-Net: stages of residual blocks joined by stride-2 4x4
    convs, a bottleneck of `n_dilated` dilated 3x3 convs (dilation 2, 4,
    ...) summed with its input, and a decoder of transpose convs, skip
    concatenation, a 3x3 conv and residual blocks; a 3x3 head."""

    def __init__(self, in_channels=1, out_channels=1, hidden=(32, 64, 128),
                 n_resblocks=2, n_dilated=3, gated=False, seed=0):
        super().__init__()
        g = _generator(seed)
        hidden = tuple(hidden)
        self.hidden, self.n_resblocks = hidden, n_resblocks
        self.n_dilated = n_dilated
        self._child("Conv", _same(in_channels, hidden[0], 3, g))
        for i, f in enumerate(hidden):
            for _ in range(n_resblocks):
                self._child("_GatedResBlock", _GatedResBlock(f, g, gated))
            if i < len(hidden) - 1:
                self._child("Conv", _conv(f, hidden[i + 1], 4, g, stride=2,
                                          padding=1))
        for k in range(n_dilated):
            self._child("Conv", _same(hidden[-1], hidden[-1], 3, g,
                                      dilation=2 ** (k + 1)))
            self._child("GroupNorm", _group_norm(math.gcd(8, hidden[-1]),
                                                 hidden[-1]))
        for i in reversed(range(len(hidden) - 1)):
            self._child("ConvTranspose", _conv_t(hidden[i + 1], hidden[i], g))
            self._child("Conv", _same(2 * hidden[i], hidden[i], 3, g))
            for _ in range(n_resblocks):
                self._child("_GatedResBlock",
                            _GatedResBlock(hidden[i], g, gated))
        self._child("Conv", _same(hidden[0], out_channels, 3, g))

    def forward(self, x, train: bool = False):
        conv = iter(getattr(self, f"Conv_{i}") for i in
                    range(self._kind_counts["Conv"]))
        block = iter(getattr(self, f"_GatedResBlock_{i}") for i in
                     range(self._kind_counts["_GatedResBlock"]))
        h = next(conv)(_nhwc_in(x))
        skips = []
        for i in range(len(self.hidden)):
            for _ in range(self.n_resblocks):
                h = next(block)(h, train)
            skips.append(h)
            if i < len(self.hidden) - 1:
                h = next(conv)(h)
        d_sum = h
        for k in range(self.n_dilated):
            h = F.relu(getattr(self, f"GroupNorm_{k}")(next(conv)(h)))
            d_sum = d_sum + h
        h = d_sum
        for j, i in enumerate(reversed(range(len(self.hidden) - 1))):
            h = getattr(self, f"ConvTranspose_{j}")(h)
            h = next(conv)(torch.cat([h, skips[i]], dim=1))
            for _ in range(self.n_resblocks):
                h = next(block)(h, train)
        return _nhwc_out(next(conv)(h))


class ImplicitConv(_Named):
    """`depth` 1x1 convs over the pixels, InstanceNorm + LeakyReLU(0.2)
    between them, a tanh head."""

    def __init__(self, in_channels=1, out_channels=1, width=64, depth=10,
                 seed=0):
        super().__init__()
        g = _generator(seed)
        cin = in_channels
        for _ in range(depth - 1):
            self._child("Conv", _conv(cin, width, 1, g))
            cin = width
        self._child("Conv", _conv(cin, out_channels, 1, g))
        self.depth = depth

    def forward(self, x, train: bool = False):
        h = _nhwc_in(x)
        for i in range(self.depth - 1):
            h = F.leaky_relu(_norm(getattr(self, f"Conv_{i}")(h)), 0.2)
        return _nhwc_out(torch.tanh(getattr(self, f"Conv_{self.depth - 1}")(h)))


class _ResBlock(nn.Module):
    """Reflection-padded 3x3 conv, InstanceNorm, ReLU, again without the
    ReLU, then ReLU of the sum with the input."""

    def __init__(self, features, g):
        super().__init__()
        self.Conv_0 = _conv(features, features, 3, g)
        self.Conv_1 = _conv(features, features, 3, g)

    def forward(self, x):
        h = F.relu(_norm(self.Conv_0(F.pad(x, (1, 1, 1, 1), mode="reflect"))))
        h = _norm(self.Conv_1(F.pad(h, (1, 1, 1, 1), mode="reflect")))
        return F.relu(x + h)


class ResNetED(_Named):
    """Residual encoder-decoder without skips: a 3x3 stem, `n_down` stages
    of `n_blocks` residual blocks, a 2x2 max pool and a 3x3 conv doubling
    the width; `n_blocks` more blocks; `n_down` transpose convs + ReLU; a
    3x3 head."""

    def __init__(self, in_channels=1, out_channels=1, base_filters=32,
                 n_down=3, n_blocks=2, seed=0):
        super().__init__()
        g = _generator(seed)
        f = base_filters
        self.n_down, self.n_blocks = n_down, n_blocks
        self._child("Conv", _same(in_channels, f, 3, g))
        for i in range(n_down):
            for _ in range(n_blocks):
                self._child("_ResBlock", _ResBlock(f * 2**i, g))
            self._child("Conv", _same(f * 2**i, f * 2 ** (i + 1), 3, g))
        for _ in range(n_blocks):
            self._child("_ResBlock", _ResBlock(f * 2**n_down, g))
        for i in reversed(range(n_down)):
            self._child("ConvTranspose", _conv_t(f * 2 ** (i + 1), f * 2**i,
                                                 g))
        self._child("Conv", _same(f, out_channels, 3, g))

    def forward(self, x, train: bool = False):
        h = self.Conv_0(_nhwc_in(x))
        blocks = iter(getattr(self, f"_ResBlock_{i}") for i in
                      range((self.n_down + 1) * self.n_blocks))
        for i in range(self.n_down):
            for _ in range(self.n_blocks):
                h = next(blocks)(h)
            h = getattr(self, f"Conv_{i + 1}")(F.max_pool2d(h, 2))
        for _ in range(self.n_blocks):
            h = next(blocks)(h)
        for j in range(self.n_down):
            h = F.relu(getattr(self, f"ConvTranspose_{j}")(h))
        return _nhwc_out(getattr(self, f"Conv_{self.n_down + 1}")(h))


class LocalConv2d(nn.Module):
    """Locally connected (unshared-weight) conv, valid and stride 1:
    ``[B, H, W, in_channels] -> [B, H - kh + 1, W - kw + 1, features]``.
    Each output location has its own kernel ``kernel[y, x]`` of shape
    ``(kh kw in_channels, features)`` over the patch's channels (taps in
    row-major order, channels fastest) and its own bias. Parameters keep
    the flax layout and names (``kernel``, ``bias``); each location's
    kernel starts as a lecun normal over its own fan-in kh kw C."""

    def __init__(self, features, kernel=(3, 3), in_size=(64, 64),
                 in_channels=1, seed=0):
        super().__init__()
        kh, kw = kernel
        H, W = in_size
        self.kernel_size, self.in_size = (kh, kw), (H, W)
        ho, wo = H - kh + 1, W - kw + 1
        self.kernel = nn.Parameter(torch.empty(ho, wo, kh * kw * in_channels,
                                               features))
        self.bias = nn.Parameter(torch.zeros(ho, wo, features))
        _lecun_(self.kernel, kh * kw * in_channels, _generator(seed))

    def forward(self, x, train: bool = False):
        kh, kw = self.kernel_size
        if tuple(x.shape[1:3]) != self.in_size:
            raise ValueError(
                f"LocalConv2d(in_size={self.in_size}) got input "
                f"{tuple(x.shape[1:3])}: per-location kernels are sized to "
                "in_size")
        ho, wo = self.kernel.shape[:2]
        p = torch.cat([x[:, i:i + ho, j:j + wo, :] for i in range(kh)
                       for j in range(kw)], dim=-1)
        return torch.einsum("bhwk,hwkf->bhwf", p, self.kernel) + self.bias
