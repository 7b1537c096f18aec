"""Parameters from the JAX package to the port."""

from __future__ import annotations

import zlib
from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "flax_shapes", "seeded_params"]


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple, value) -> tuple[str, torch.Tensor]:
    """One flax leaf as the port's state-dict entry. The port's networks
    name their submodules as flax does (``Conv_0``, ``Down_1/Conv_0``,
    ``ConvTranspose_2``, ``MLP_0/Dense_1``), so only the leaf changes:
      * a conv ``kernel`` (1D WIO, 2D HWIO, 3D DHWIO) becomes ``weight``
        laid out (out, in, *spatial); a transpose conv's is flipped in
        every spatial axis and laid out (in, out, *spatial);
      * a ``Dense`` kernel (in, out) becomes ``weight`` (out, in);
      * a ``GroupNorm`` scale becomes ``weight``;
      * a ``LocalConv2d`` kernel (Ho, Wo, K, F), a parameter of the module
        itself and not a conv, keeps its name and layout."""
    a = np.array(value)
    *mods, name = path
    owner = mods[-1] if mods else ""
    if name == "kernel" and not owner.startswith("LocalConv2d") and mods:
        nsp = a.ndim - 2
        if nsp == 0:
            a = a.T
        elif owner.startswith("ConvTranspose"):
            a = a[(slice(None, None, -1),) * nsp].transpose(
                nsp, nsp + 1, *range(nsp))
        else:
            a = a.transpose(nsp + 1, nsp, *range(nsp))
        name = "weight"
    elif name == "scale" and owner.startswith("GroupNorm"):
        name = "weight"
    return ".".join(mods + [name]), torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's parameters, as numpy arrays, as the port's state
    dict: a ``DirectField``'s flat ``{"field"}`` or ``{"field_i"}`` as they
    are, a flax network's tree (with or without its ``"params"`` root) by
    :func:`_leaf`."""
    if all(not isinstance(v, Mapping) for v in params.values()):
        return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    if set(params) == {"params"}:
        params = params["params"]
    return dict(_leaf(path, v) for path, v in _flatten(params))


def flax_shapes(module: torch.nn.Module) -> dict:
    """The shapes of the flax tree that :func:`params_from_jax` maps onto
    `module`'s state dict (without the ``"params"`` root): the inverse of
    :func:`_leaf` on shapes."""
    tree: dict = {}
    for key, value in module.state_dict().items():
        *mods, name = key.split(".")
        owner = mods[-1] if mods else ""
        shape = tuple(value.shape)
        if name == "weight" and owner.startswith("GroupNorm"):
            name = "scale"
        elif name == "weight":
            if owner.startswith("ConvTranspose"):
                shape = shape[2:] + shape[:2]
            else:
                shape = shape[2:] + shape[1::-1]
            name = "kernel"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = shape
    return tree


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    x = rng.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return x


def seeded_params(shapes: Mapping, seed: int, prefix: tuple = ()) -> dict:
    """A flax parameter tree of the given shapes drawn with numpy from
    `seed`, by flax's default initializers: a ``kernel`` lecun_normal
    (a normal truncated at two standard deviations, scaled to variance
    1 / fan_in, the fan-in being every axis but the last, or the last but
    one of a ``LocalConv2d`` kernel, the (Ho, Wo, K, F) kernel of the
    module itself), a ``scale`` ones, anything else
    zeros. Each leaf draws from its own stream, keyed by `seed` and its
    path, so the tree does not depend on the order of its keys. The
    reference scripts draw the JAX package's initial weights by the same
    rule, so both packages can start from the same network."""
    tree = {}
    for k, v in shapes.items():
        path = prefix + (k,)
        if isinstance(v, Mapping):
            tree[k] = seeded_params(v, seed, path)
            continue
        shape = tuple(v)
        if k == "kernel":
            local = len(shape) == 4 and (
                not prefix or prefix[-1].startswith("LocalConv2d"))
            fan_in = shape[-2] if local else int(np.prod(shape[:-1]))
            rng = np.random.default_rng(
                [seed, zlib.crc32("/".join(path).encode())])
            a = _truncated_normal(rng, shape) * (
                np.sqrt(1.0 / fan_in) / 0.87962566103423978)
        else:
            a = np.full(shape, 1.0 if k == "scale" else 0.0)
        tree[k] = a.astype(np.float32)
    return tree
