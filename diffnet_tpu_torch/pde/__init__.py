from .base import FEM2DModule, FEM3DModule, PDEModule
from .poisson import Poisson2D, Poisson3D

__all__ = ["PDEModule", "FEM2DModule", "FEM3DModule", "Poisson2D",
           "Poisson3D"]
