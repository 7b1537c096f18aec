from . import fdm, fem, geometry, interp
from .quadrature import FEMBasis, make_basis

__all__ = ["fdm", "fem", "geometry", "interp", "FEMBasis", "make_basis"]
