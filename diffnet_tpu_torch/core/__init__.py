from . import fem
from .quadrature import FEMBasis, make_basis

__all__ = ["fem", "FEMBasis", "make_basis"]
