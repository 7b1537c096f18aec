"""Parameters from the JAX package to the port."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple, value) -> tuple[str, torch.Tensor]:
    """One flax leaf as the port's state-dict entry. The port's networks
    name their submodules as flax does (``Conv_0``, ``Down_1/Conv_0``,
    ``ConvTranspose_2``), so only the leaf changes: ``kernel`` becomes
    ``weight``, HWIO becomes OIHW, and a transpose conv's kernel is flipped
    in both spatial axes and laid out (in, out, kh, kw)."""
    a = np.array(value)
    *mods, name = path
    if name == "kernel" and a.ndim == 4:
        if mods[-1].startswith("ConvTranspose"):
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            a = a.transpose(3, 2, 0, 1)
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
