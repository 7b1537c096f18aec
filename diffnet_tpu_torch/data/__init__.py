from .loader import NumpyLoader
from .single_instances import (Rectangle, RectangleManufactured,
                               SingleInstanceDataset)

__all__ = ["NumpyLoader", "SingleInstanceDataset", "Rectangle",
           "RectangleManufactured"]
