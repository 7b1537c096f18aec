"""Coarse-to-fine grid continuation for direct-field solves (port of
``diffnet_tpu/train/continuation.py``).

Solving on a coarse grid and prolongating the fields as the fine grid's
initial guess recovers the smooth modes cheaply (nested iteration);
:func:`prolong_field` is also the multigrid prolongation of
``train.linear.multigrid_preconditioner``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .trainer import Trainer

__all__ = ["prolong_field", "coarse_to_fine"]


def _node_coords(c: int, f: int) -> np.ndarray:
    """``jnp.linspace(0, c - 1, f)`` in float32, as JAX computes it:
    ``stop * (i / (f - 1))`` for i < f - 1, then ``stop`` exactly."""
    if f == 1:
        return np.zeros(1, np.float32)
    step = np.arange(f - 1, dtype=np.float32) / np.float32(f - 1)
    return np.append(np.float32(c - 1) * step, np.float32(c - 1))


def prolong_field(field: torch.Tensor, fine_shape,
                  method: str = "linear") -> torch.Tensor:
    """Prolongate a nodal field (``[..., ny, nx]`` or ``[..., nz, ny, nx]``)
    to a finer grid with node-aligned interpolation: coarse node 0 maps to
    fine node 0 and coarse node -1 to fine node -1, so a 2x refinement
    injects the coarse values at the even fine nodes.

    method: ``"linear"`` (bilinear / trilinear, ``align_corners=True``,
    whose sample points are ``linspace(0, c - 1, f)``) or ``"nearest"``
    (the nearest node, ties, which a 2x refinement hits at every odd node,
    rounded half away from zero as ``map_coordinates(order=0)`` rounds)."""
    fine_shape = tuple(int(s) for s in fine_shape)
    nsd = len(fine_shape)
    coarse_shape = tuple(field.shape[-nsd:])
    lead = field.shape[:-nsd]
    if method in ("linear", "bilinear", "trilinear"):
        if nsd not in (2, 3):
            raise ValueError(f"linear prolongation needs 2 or 3 spatial "
                             f"axes, got {nsd}")
        mode = "bilinear" if nsd == 2 else "trilinear"
        flat = field.reshape((-1, 1) + coarse_shape)
        out = F.interpolate(flat, size=fine_shape, mode=mode,
                            align_corners=True)
        return out.reshape(lead + fine_shape)
    if method == "nearest":
        out = field
        for ax, (c, f) in enumerate(zip(coarse_shape, fine_shape)):
            x = _node_coords(c, f).astype(np.float64)
            idx = np.clip(np.floor(x + 0.5).astype(np.int64), 0, c - 1)
            out = out.index_select(field.ndim - nsd + ax,
                                   torch.from_numpy(idx).to(field.device))
        return out
    raise ValueError(f"unsupported prolongation method {method!r}; use "
                     "'linear' (2D/3D) or 'nearest'")


def coarse_to_fine(module_factory: Callable[[int], tuple],
                   grids: Sequence[int], epochs: Sequence[int] | int,
                   optimizer: str = "lbfgs", lbfgs_max_iter: int = 10,
                   dataloader_factory: Callable[[int], object] | None = None,
                   device="cuda"):
    """Nested-iteration solve over a grid hierarchy.

    module_factory(n) -> (module, network) for grid size n, the network a
    ``DirectField`` whose parameters are nodal fields ``[n, n]`` or
    ``[n, n, n]``. Each grid trains with ``Trainer(device=device)`` (the
    card by default) from
    the previous grid's fields, prolongated. Returns the final
    ``(module, state)``."""
    device = resolve_device(device, "coarse_to_fine")
    if isinstance(epochs, int):
        epochs = [epochs] * len(grids)
    params = None
    module = state = None
    for n, ep in zip(grids, epochs):
        module, network = module_factory(n)
        if params is not None:
            nsd = module.nsd
            with torch.no_grad():
                params = {k: prolong_field(v, (n,) * nsd)
                          for k, v in params.items()}
        trainer = Trainer(max_epochs=ep, optimizer=optimizer,
                          lbfgs_max_iter=lbfgs_max_iter, device=device)
        loader = (dataloader_factory(n) if dataloader_factory is not None
                  else None)
        state = trainer.fit(module, loader, params=params)
        params = state.params
    return module, state
