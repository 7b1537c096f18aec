from .device import resolve_device
from .export import export_forward, load_exported, save_exported
from .mesh3d import field_to_obj, surface_nets, write_obj
from .precond import ilu_from_operator, load_ilu_mat
from .vti import VtiWriter, write_vti

__all__ = ["load_ilu_mat", "ilu_from_operator", "resolve_device",
           "export_forward", "save_exported", "load_exported",
           "VtiWriter", "write_vti", "surface_nets", "write_obj",
           "field_to_obj"]
