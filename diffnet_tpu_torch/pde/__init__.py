from .base import FEM2DModule, FEM3DModule, PDEModule
from .flow import (FlowWeakFormLDC, NavierStokes, StokesMMS, StokesNSBase,
                   calc_tau, ldc_bcs)
from .ibn import IBNPoisson2D, IBNPoisson3D
from .poisson import Poisson2D, Poisson3D

__all__ = ["PDEModule", "FEM2DModule", "FEM3DModule", "Poisson2D",
           "Poisson3D", "IBNPoisson2D", "IBNPoisson3D",
           "StokesNSBase", "StokesMMS",
           "NavierStokes", "FlowWeakFormLDC", "calc_tau", "ldc_bcs"]
