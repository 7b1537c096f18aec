"""Parameters from the JAX package to the port."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(params: Mapping[str, np.ndarray]
                    ) -> dict[str, torch.Tensor]:
    """The JAX package's parameters, as numpy arrays, as the port's state
    dict. For a ``DirectField`` the names carry over as they are:
    ``{"field"}`` or ``{"field_i"}``."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
