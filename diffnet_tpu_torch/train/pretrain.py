"""Autoencoder pretraining on an image set (port of
``diffnet_tpu/train/pretrain.py``): the MSE reconstruction loop whose
weights later start a solution network.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.loader import NumpyLoader
from ..utils.device import resolve_device
from .trainer import save_params

__all__ = ["ArrayImageDataset", "pretrain_autoencoder"]


class ArrayImageDataset:
    """Images ``[N, H, W]`` or ``[N, H, W, C]`` as (x, x) reconstruction
    pairs, float32 channels-last."""

    def __init__(self, images):
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[..., None]
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        x = self.images[idx]
        return x, x


def pretrain_autoencoder(model: torch.nn.Module, dataset, epochs=10,
                         batch_size=16, learning_rate=1e-3, seed=42,
                         save_path=None, verbose=False, device="cuda"):
    """Train `model` in place to reconstruct `dataset`'s images: Adam on
    the mean squared error (plus 1e-3 x the KL term when the model returns
    ``(recon, mu, logvar)``), batches shuffled by `seed`, the last partial
    batch kept. Returns the trained state dict (also saved to
    `save_path`)."""
    device = resolve_device(device, "pretrain_autoencoder")
    model.to(device)
    # a batch no larger than the dataset, so the loader yields one
    batch_size = min(batch_size, len(dataset))
    loader = NumpyLoader(dataset, batch_size=batch_size, shuffle=True,
                         seed=seed, drop_last=False, device=device)
    # the JAX package draws one batch for its init first; drawing it here
    # too keeps the two packages on the same shuffle stream
    next(iter(loader))
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate)

    def loss_fn(x):
        out = model(x)
        if isinstance(out, tuple):
            recon, mu, logvar = out
            kl = -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar))
            return torch.mean((recon - x) ** 2) + 1e-3 * kl
        return torch.mean((out - x) ** 2)

    model.train()
    for epoch in range(epochs):
        losses = []
        for x, _ in loader:
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(x)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if verbose:
            print(f"epoch {epoch}: recon_mse "
                  f"{float(torch.stack(losses).mean()):.3e}")

    params = model.state_dict()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        save_params(params, save_path)
    return params
