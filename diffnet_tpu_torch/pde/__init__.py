from .base import FEM2DModule, PDEModule
from .poisson import Poisson2D

__all__ = ["PDEModule", "FEM2DModule", "Poisson2D"]
