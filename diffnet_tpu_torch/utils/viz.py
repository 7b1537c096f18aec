"""Matplotlib plots on the host (port of ``diffnet_tpu/utils/viz.py``):
contour panels, line cuts, an epoch-end contour callback for the
``Trainer``, loss curves from a run's metrics.csv and point histograms.

They take numpy arrays (or tensors, which they copy to the host).
matplotlib is imported inside each function: neither importing the
package nor training needs it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..train.trainer import Callback

__all__ = ["plot_contours", "plot_line_cuts", "ContourPlotCallback",
           "plot_losses", "plot_point_histograms"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_contours(save_path, fields: dict, ncols=None, cmap="jet",
                  suptitle=None):
    """A grid of imshow panels with colorbars; fields: {title: 2D array}."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    names = list(fields)
    n = len(names)
    ncols = ncols or n
    nrows = (n + ncols - 1) // ncols
    fig, axs = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 2.6 * nrows),
                            squeeze=False)
    for i, name in enumerate(names):
        ax = axs[i // ncols][i % ncols]
        im = ax.imshow(_host(fields[name]), cmap=cmap, origin="lower")
        ax.set_title(name, fontsize=9)
        ax.set_xticks([]); ax.set_yticks([])
        fig.colorbar(im, ax=ax)
    if suptitle:
        fig.suptitle(suptitle, fontsize=10)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return save_path


def plot_line_cuts(save_path, u, u_exact=None, cuts=(0.2, 0.5, 0.8),
                   lengths=(1.0, 1.0)):
    """Line cuts of u (and an optional exact overlay) at x and y in
    `cuts`."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    u = _host(u)
    ny, nx = u.shape
    x = np.linspace(0, lengths[0], nx)
    y = np.linspace(0, lengths[1], ny)
    fig, axs = plt.subplots(2, len(cuts), figsize=(3.0 * len(cuts), 5.2),
                            squeeze=False)
    for j, c in enumerate(cuts):
        iy = int(round(c * (ny - 1)))
        ix = int(round(c * (nx - 1)))
        axs[0][j].plot(x, u[iy, :], "-", label="u")
        axs[1][j].plot(y, u[:, ix], "-", label="u")
        if u_exact is not None:
            ue = _host(u_exact)
            axs[0][j].plot(x, ue[iy, :], "--", label="exact")
            axs[1][j].plot(y, ue[:, ix], "--", label="exact")
        axs[0][j].set_title(f"y = {c}", fontsize=9)
        axs[1][j].set_title(f"x = {c}", fontsize=9)
    axs[0][0].legend(fontsize=8)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return save_path


class ContourPlotCallback(Callback):
    """Trainer callback: save the contour panel of the first sample's
    solution every `every` epochs, as ``contour_{epoch}.png`` in
    `out_dir`."""

    def __init__(self, every=50, out_dir="."):
        self.every = every
        self.out_dir = out_dir

    @torch.no_grad()
    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        if epoch % self.every or module.dataset is None:
            return
        batch = tuple(torch.as_tensor(np.asarray(a))[None].to(trainer.device)
                      for a in module.dataset[0])
        u, inputs, _ = module(batch)
        u = module.apply_bcs(u, inputs)
        if isinstance(u, tuple):
            u = u[0]
        u2 = _host(u)[0]
        while u2.ndim > 2:
            u2 = u2[..., 0] if u2.shape[-1] <= 4 else u2[0]
        plot_contours(
            os.path.join(self.out_dir, f"contour_{epoch}.png"),
            {"u": u2})


def plot_losses(run_dir, save_name="losses.png", log_scale=True):
    """The loss curve(s) of a run's metrics.csv (the Trainer's CSVLogger)."""
    import csv

    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    path = os.path.join(run_dir, "metrics.csv")
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    epochs = [int(float(r["epoch"])) for r in rows]
    fig, ax = plt.subplots(figsize=(5, 3.2))
    for key in rows[0]:
        if "loss" in key.lower():
            ax.plot(epochs, [float(r[key]) for r in rows], label=key)
    if log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.legend(fontsize=8)
    out = os.path.join(run_dir, save_name)
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


def plot_point_histograms(save_path, histograms, bins=30):
    """Histograms of the solution value at probe points across a UQ
    ensemble. `histograms`: {point: samples}, as
    ``train.query.point_histograms`` returns them."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    pts = list(histograms)
    fig, axs = plt.subplots(1, len(pts), figsize=(3.0 * len(pts), 2.6),
                            squeeze=False)
    for i, pt in enumerate(pts):
        axs[0][i].hist(_host(histograms[pt]), bins=bins)
        axs[0][i].set_title(f"u at {pt}", fontsize=9)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return save_path
