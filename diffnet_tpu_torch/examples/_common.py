"""What the example CLIs share: the two flags the port adds, the device,
host copies, and the PNG panels (matplotlib when it is installed, else a
plain rasterised PNG written with numpy and zlib, so that a machine
without matplotlib still gets every artifact)."""

from __future__ import annotations

import argparse
import importlib.util
import os
import struct
import zlib

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["add_port_flags", "device_of", "no_kernel", "host",
           "save_contours", "save_lines"]

def add_port_flags(p: argparse.ArgumentParser) -> None:
    """``--device`` and ``--fused-kernels``."""
    p.add_argument("--device", default="cuda",
                   help="where the run goes: cuda (default; raises without "
                        "a card) or cpu (every kernel's plain version)")
    p.add_argument("--fused-kernels", action="store_true",
                   help="the modules' fused_kernels option: the hand-"
                        "written CUDA kernels in the losses and solves")


def device_of(args, caller: str) -> torch.device:
    return resolve_device(args.device, caller)


def no_kernel(p: argparse.ArgumentParser, args, what: str) -> None:
    """Refuse ``--fused-kernels`` for a module that has no fused path."""
    if args.fused_kernels:
        p.error(f"--fused-kernels: {what} has no fused kernel")


def host(a) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] in [0, 1]."""
    img = np.clip(np.asarray(rgb) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _jet(t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)[..., None]
    return np.clip(1.5 - np.abs(4.0 * t - np.array([3.0, 2.0, 1.0])), 0, 1)


def _panel_row(panels: list, gap: int = 4) -> np.ndarray:
    h = max(p.shape[0] for p in panels)
    out = []
    for p in panels:
        pad = np.ones((h, p.shape[1], 3))
        pad[:p.shape[0]] = p
        out += [pad, np.ones((h, gap, 3))]
    return np.concatenate(out[:-1], axis=1)


def save_contours(path: str, fields: dict) -> str:
    """Contour panels of 2D fields, one per entry (``plot_contours``), or
    without matplotlib each field colour-mapped side by side, y up."""
    fields = {k: host(v) for k, v in fields.items()}
    if _have_matplotlib():
        from ..utils.viz import plot_contours

        return plot_contours(path, fields)
    panels = []
    for a in fields.values():
        a = np.asarray(a, np.float64)[::-1]
        lo, hi = np.nanmin(a), np.nanmax(a)
        t = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
        k = max(1, 128 // max(a.shape))
        panels.append(np.kron(_jet(t), np.ones((k, k, 1))))
    _write_png(path, _panel_row(panels))
    return path


def save_lines(path: str, panels: list, titles=()) -> str:
    """Line plots, one panel per entry of `panels` (a list of
    ``(x, y, style, label)`` series), or without matplotlib each series
    rasterised as points on a 256^2 panel."""
    if _have_matplotlib():
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, axs = plt.subplots(1, len(panels),
                                figsize=(4 * len(panels), 3.2))
        axs = np.atleast_1d(axs)
        for ax, series, title in zip(axs, panels,
                                     list(titles) + [""] * len(panels)):
            for x, y, style, label in series:
                ax.plot(x, y, style, label=label,
                        **({"ms": 4, "mfc": "none"} if "o" in style else {}))
            ax.set_title(title, fontsize=10)
        axs[0].legend(fontsize=8)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, bbox_inches="tight", dpi=130)
        plt.close(fig)
        return path
    size, out = 256, []
    colours = np.array([[0.1, 0.3, 0.9], [0.9, 0.3, 0.1], [0.1, 0.7, 0.2]])
    for series in panels:
        canvas = np.ones((size, size, 3))
        xs = np.concatenate([np.asarray(s[0], float) for s in series])
        ys = np.concatenate([np.asarray(s[1], float) for s in series])
        span = [(a.min(), max(a.max(), a.min() + 1e-12)) for a in (xs, ys)]
        for c, (x, y, _, _) in enumerate(series):
            i = ((np.asarray(x, float) - span[0][0])
                 / (span[0][1] - span[0][0]) * (size - 1)).astype(int)
            j = ((np.asarray(y, float) - span[1][0])
                 / (span[1][1] - span[1][0]) * (size - 1)).astype(int)
            canvas[size - 1 - j, i] = colours[c % len(colours)]
        out.append(canvas)
    _write_png(path, _panel_row(out))
    return path
