from .device import resolve_device
from .export import export_forward, load_exported, save_exported
from .mesh3d import field_to_obj, surface_nets, write_obj
from .precond import ilu_from_operator, load_ilu_mat
from .viz import (ContourPlotCallback, plot_contours, plot_line_cuts,
                  plot_losses, plot_point_histograms)
from .vti import VtiWriter, write_vti
from .xyzna import read_xyzna, write_xyzna

__all__ = ["load_ilu_mat", "ilu_from_operator", "resolve_device",
           "export_forward", "save_exported", "load_exported",
           "VtiWriter", "write_vti", "surface_nets", "write_obj",
           "field_to_obj", "plot_contours", "plot_line_cuts",
           "ContourPlotCallback", "plot_losses", "plot_point_histograms",
           "read_xyzna", "write_xyzna"]
