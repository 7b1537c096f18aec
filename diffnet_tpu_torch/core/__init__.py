from . import fem, geometry
from .quadrature import FEMBasis, make_basis

__all__ = ["fem", "geometry", "FEMBasis", "make_basis"]
