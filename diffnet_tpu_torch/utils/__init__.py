from .device import resolve_device
from .precond import ilu_from_operator, load_ilu_mat
from .vti import VtiWriter, write_vti

__all__ = ["load_ilu_mat", "ilu_from_operator", "resolve_device",
           "VtiWriter", "write_vti"]
