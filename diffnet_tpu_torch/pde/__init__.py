from .advection import AdvDiff2D
from .base import FDMModule, FEM2DModule, FEM3DModule, PDEModule
from .eikonal import (Eikonal2D, Eikonal3D, EikonalFDM2D,
                      eikonal_gn_residual, signed_occupancy_init)
from .elasticity import ElasticFSDT
from .flow import (FlowWeakFormLDC, NavierStokes, StokesMMS, StokesNSBase,
                   calc_tau, ldc_bcs)
from .helmholtz import Helmholtz2D
from .ibn import IBNPoisson2D, IBNPoisson3D
from .poisson import Poisson2D, Poisson3D, PoissonFDM2D, PoissonTwoDof2D
from .spacetime import AllenCahnIceMelt, BurgersSpaceTime, SpaceTimeHeat
from .topopt import TopOpt2D, median_filter_3x3

__all__ = ["PDEModule", "FEM2DModule", "FEM3DModule", "Poisson2D",
           "Poisson3D", "IBNPoisson2D", "IBNPoisson3D",
           "StokesNSBase", "StokesMMS",
           "NavierStokes", "FlowWeakFormLDC", "calc_tau", "ldc_bcs",
           "FDMModule", "PoissonFDM2D", "PoissonTwoDof2D", "Helmholtz2D",
           "AdvDiff2D", "SpaceTimeHeat", "AllenCahnIceMelt",
           "BurgersSpaceTime", "Eikonal2D", "Eikonal3D", "EikonalFDM2D",
           "eikonal_gn_residual", "signed_occupancy_init", "ElasticFSDT",
           "TopOpt2D", "median_filter_3x3"]
