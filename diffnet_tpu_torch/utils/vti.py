"""VTK ImageData (.vti) writer, numpy only (the port's own copy of
``diffnet_tpu/utils/vti.py``).

Point or cell data of a 2D ``[ny, nx]`` or 3D ``[nz, ny, nx]`` field, in
ASCII (``"%.4E"``, the default, as DiffNet writes it) or lossless binary
(base64 of little-endian float64), readable by ParaView.
"""

from __future__ import annotations

import base64
import struct

import numpy as np

__all__ = ["VtiWriter", "write_vti"]


class VtiWriter:
    """extent (p0, p1), origin, spacing — reference vtiWriter ctor
    (vti_writer.py:4-17)."""

    def __init__(self, p0, p1, origin, spacing):
        self.p0 = tuple(int(v) for v in p0)
        self.p1 = tuple(int(v) for v in p1)
        self.origin = tuple(float(v) for v in origin)
        self.spacing = tuple(float(v) for v in spacing)

    def _header(self, f):
        e = (self.p0[0], self.p1[0], self.p0[1], self.p1[1], self.p0[2],
             self.p1[2])
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="ImageData" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write('<ImageData WholeExtent="%d %d %d %d %d %d" '
                'Origin="%.9g %.9g %.9g" Spacing="%.9g %.9g %.9g">\n'
                % (e + self.origin + self.spacing))
        f.write('<Piece Extent="%d %d %d %d %d %d">\n' % e)

    def _footer(self, f):
        f.write("</Piece>\n</ImageData>\n</VTKFile>\n")

    @staticmethod
    def _data_array(f, data, name, ascii_mode):
        data = np.asarray(data, np.float64).reshape(-1)
        if ascii_mode:
            f.write('<DataArray type="Float64" Name="%s" format="ascii">\n'
                    % name)
            f.write(" ".join("%.4E" % v for v in data))
            f.write("\n</DataArray>\n")
        else:
            raw = data.astype("<f8").tobytes()
            payload = struct.pack("<I", len(raw)) + raw
            f.write('<DataArray type="Float64" Name="%s" format="binary">\n'
                    % name)
            f.write(base64.b64encode(payload).decode())
            f.write("\n</DataArray>\n")

    def write(self, path, arrays: dict, as_celldata=False, ascii_mode=True):
        """arrays: {name: ndarray}; point-data by default (reference
        vti_from_vector, vti_writer.py:59-114)."""
        kind = "CellData" if as_celldata else "PointData"
        first = next(iter(arrays))
        with open(path, "w") as f:
            self._header(f)
            f.write('<%s Scalars="%s">\n' % (kind, first))
            for name, data in arrays.items():
                self._data_array(f, data, name, ascii_mode)
            f.write("</%s>\n" % kind)
            self._footer(f)


def write_vti(path, field, origin=(0.0, 0.0, 0.0), spacing=None, name="u",
              as_celldata=False, ascii_mode=True):
    """One-call export of a 2D [ny, nx] or 3D [nz, ny, nx] field (replaces
    the reference free functions vti_from_{txt,npy,vector},
    vti_writer.py:117-216)."""
    field = np.asarray(field)
    if field.ndim == 2:
        ny, nx = field.shape
        dims = (nx, ny, 1)
    elif field.ndim == 3:
        nz, ny, nx = field.shape
        dims = (nx, ny, nz)
    else:
        raise ValueError(f"field must be 2D or 3D, got shape {field.shape}")
    if spacing is None:
        # point data: d nodes span [0,1] -> 1/(d-1); cell data: the field
        # entries ARE the d cells -> 1/d (1/(d-1) stretched the domain to
        # d/(d-1), misaligning cell overlays by one cell at the far edge)
        div = (lambda d: max(1, d)) if as_celldata else (
            lambda d: max(1, d - 1))
        spacing = tuple(1.0 / div(d) for d in dims)
    off = 0 if as_celldata else 1
    p1 = tuple(max(0, d - off) for d in dims)
    w = VtiWriter((0, 0, 0), p1, origin, spacing)
    w.write(path, {name: field}, as_celldata=as_celldata,
            ascii_mode=ascii_mode)
