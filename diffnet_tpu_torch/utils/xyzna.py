"""Point-cloud .xyzna ASCII IO (the port's numpy copy of
``diffnet_tpu/utils/xyzna.py``).

The format (that of the reference's xyzna writer and reader, and of the
shipped ``model.xyzna``) is a BLOCK layout:

    N
    x y z        (N lines)
    nx ny nz     (N lines)
    area         (N lines)

``read_xyzna`` also accepts a flat column layout (``x y z nx ny nz [area]``
per line, no header) for interop with generic tools; ``write_xyzna`` emits
the reference block format so files round-trip through the reference reader.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_xyzna", "write_xyzna"]


def read_xyzna(path):
    """Returns (points[N,3], normals[N,3], areas[N]); areas zero-filled if
    absent."""
    with open(path) as f:
        first = f.readline().split()
    if len(first) == 1:
        # reference block format with a count header (rows are ragged across
        # blocks — 3 columns then 1 — so parse by streaming like the
        # reference reader does)
        with open(path) as f:
            n = int(f.readline().strip())
            points = np.array([[float(v) for v in f.readline().split()[:3]]
                               for _ in range(n)])
            normals = np.array([[float(v) for v in f.readline().split()[:3]]
                                for _ in range(n)])
            areas = []
            for _ in range(n):
                line = f.readline().split()
                if not line:
                    break
                areas.append(float(line[0]))
        if areas and len(areas) != n:
            # a short/interrupted areas block silently became all-zeros
            # before — zero areas make every winding number 0 downstream
            raise ValueError(
                f"truncated areas block in {path}: {len(areas)} of {n}")
        areas = (np.asarray(areas) if len(areas) == n else np.zeros(n))
        return points, normals, areas
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    points = data[:, 0:3]
    normals = data[:, 3:6]
    areas = data[:, 6] if data.shape[1] > 6 else np.zeros(len(data))
    return points, normals, areas


def write_xyzna(path, points, normals, areas=None):
    """Write the reference block format (count header, then point/normal/area
    blocks) so output is readable by the reference's xyzna_reader."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    normals = np.asarray(normals, np.float64).reshape(-1, 3)
    n = len(points)
    if areas is None:
        areas = np.zeros(n)
    areas = np.asarray(areas, np.float64).reshape(-1)
    with open(path, "w") as f:
        f.write(f"{n}\n")
        for row in points:
            f.write("%.18f %.18f %.18f\n" % tuple(row))
        for row in normals:
            f.write("%.18f %.18f %.18f\n" % tuple(row))
        for a in areas:
            f.write("%.18f\n" % a)
