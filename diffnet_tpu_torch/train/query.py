"""Inference and statistical (uncertainty) queries over a dataset (port of
``diffnet_tpu/train/query.py``): batched inference, the mean and standard
deviation fields, per-point samples for histograms, and ``.npy`` dumps.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.loader import NumpyLoader
from ..utils.device import resolve_device

__all__ = ["query_batched", "query_statistical", "calc_mean_stddev",
           "point_histograms", "save_query_results"]


@torch.no_grad()
def query_batched(module, dataset, batch_size=64, apply_bcs=True,
                  device="cuda") -> np.ndarray:
    """The module's solution fields over the whole dataset, stacked
    ``[N, ...]`` (numpy); with `apply_bcs` after its Dirichlet
    substitution. The module is moved to `device` (the card by default)."""
    device = resolve_device(device, "query_batched")
    module.to(device)
    loader = NumpyLoader(dataset, batch_size=batch_size, shuffle=False,
                         drop_last=False, device=device)
    outs = []
    for batch in loader:
        u, inputs, _ = module(batch)
        if apply_bcs:
            u = module.apply_bcs(u, inputs)
        if isinstance(u, tuple):
            u = u[0]
        u = u.cpu().numpy()
        if u.ndim >= 4 and u.shape[-1] == 1:
            u = u[..., 0]
        outs.append(u)
    return np.concatenate(outs, axis=0)


def calc_mean_stddev(all_u):
    """(mean, standard deviation) over the sample axis."""
    return all_u.mean(axis=0), all_u.std(axis=0)


def point_histograms(all_u, points_ij):
    """Per-point value samples for histograms; `points_ij` lists (row, col)
    indices."""
    return {tuple(p): all_u[(slice(None),) + tuple(p)] for p in points_ij}


def query_statistical(module, dataset, batch_size=64, out_dir=None,
                      prefix="q", apply_bcs=True, device="cuda"):
    """Inference sweep, then the mean and standard deviation (written as
    ``{prefix}_mean.npy`` and ``{prefix}_sdev.npy`` when `out_dir` is
    given). Returns ``(mean, sdev, all_u)``."""
    all_u = query_batched(module, dataset, batch_size, apply_bcs=apply_bcs,
                          device=device)
    mean, sdev = calc_mean_stddev(all_u)
    if out_dir is not None:
        save_query_results(out_dir, mean, sdev, prefix)
    return mean, sdev, all_u


def save_query_results(out_dir, mean, sdev, prefix="q"):
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{prefix}_mean.npy"), mean)
    np.save(os.path.join(out_dir, f"{prefix}_sdev.npy"), sdev)
