"""Serving export of a trained network's forward (port of
``diffnet_tpu/utils/export.py``, over ``torch.export`` where the JAX
package writes StableHLO): the program, with its parameters, is saved to
one file that loads and runs without the network's Python class.
"""

from __future__ import annotations

import torch

__all__ = ["export_forward", "save_exported", "load_exported"]


def export_forward(network, sample_input: torch.Tensor
                   ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``x -> network(x)`` (the inference forward: the
    port's networks take dropout only with ``train=True``) at
    `sample_input`'s shape, dtype and device, the parameters held in the
    program."""
    return torch.export.export(network, (sample_input,))


def save_exported(exported: torch.export.ExportedProgram, path: str) -> str:
    torch.export.save(exported, path)
    return path


def load_exported(path: str) -> torch.export.ExportedProgram:
    """The saved program; ``load_exported(path).module()(x)`` runs it."""
    return torch.export.load(path)
