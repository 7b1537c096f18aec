"""Direct nodal-field "network": optimise the solution field itself.

Port of ``diffnet_tpu/models/field.py``: the reference pattern
``nn.ParameterList([nn.Parameter(u)])`` whose forward returns the field.
One ``nn.Parameter`` per field, named ``field`` (one field) or
``field_0``, ``field_1``, ... (several), as the JAX package names its
params.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["DirectField"]


class DirectField(nn.Module):
    """The parameters are the nodal field(s).

    shape: field shape without the batch dim, e.g. ``(ny, nx)``. The forward
    broadcasts over the batch dim of `inputs` (a view, no copy)."""

    def __init__(self, shape, init=None, n_fields: int = 1):
        super().__init__()
        self.shape = tuple(shape)
        self.n_fields = n_fields
        if init is None:
            init = np.ones(self.shape, np.float32)
        value = np.broadcast_to(np.asarray(init, np.float32), self.shape)
        names = ["field"] if n_fields == 1 else [f"field_{i}"
                                                 for i in range(n_fields)]
        for name in names:
            self.register_parameter(
                name, nn.Parameter(torch.tensor(np.array(value))))

    def forward(self, inputs=None):
        """The field(s) with a leading batch axis of size 1, or of `inputs`'
        batch size when given."""
        b = 1 if inputs is None else inputs.shape[0]
        if self.n_fields == 1:
            return self.field[None].expand((b,) + self.shape)
        return tuple(getattr(self, f"field_{i}")[None].expand(
            (b,) + self.shape) for i in range(self.n_fields))
