"""Isosurface extraction and OBJ export for 3D fields (the port's copy of
the numpy code of ``diffnet_tpu/utils/mesh3d.py``; meshes equal the JAX
package's).

The isosurface comes from the (naive) surface-nets algorithm: one vertex
per sign-change cell, at the centroid of its edge crossings, and one quad
per grid edge that crosses the level set: a watertight quad mesh of the
surface, written as Wavefront OBJ.
"""

from __future__ import annotations

import numpy as np

__all__ = ["surface_nets", "write_obj", "field_to_obj"]

# cube edges as pairs of corner offsets (z, y, x)
_CORNERS = np.array([(z, y, x) for z in (0, 1) for y in (0, 1)
                     for x in (0, 1)])
_EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8)
          if np.sum(np.abs(_CORNERS[a] - _CORNERS[b])) == 1]


def surface_nets(field: np.ndarray, level: float = 0.5,
                 spacing=(1.0, 1.0, 1.0), close_boundary: bool = True):
    """Extract the `level` isosurface of a [nz, ny, nx] field.

    Returns (vertices [Nv, 3] xyz, quads [Nq, 4] vertex indices,
    consistently wound with normals toward the positive side).
    `close_boundary` pads the field with one "outside" layer so surfaces
    clipped by the grid boundary are capped (watertight) instead of left
    with an open rim; the cap vertices sit up to half a cell outside the
    grid extent.
    """
    f = np.asarray(field, np.float64) - level
    if close_boundary:
        f = np.pad(f, 1, constant_values=np.abs(f).max() + 1.0)
    nz, ny, nx = f.shape
    inside = f < 0

    # corner samples per cell: [nz-1, ny-1, nx-1, 8]
    cs = np.stack([f[c[0]:c[0] + nz - 1, c[1]:c[1] + ny - 1,
                     c[2]:c[2] + nx - 1] for c in _CORNERS], axis=-1)
    sign = cs < 0
    active = np.logical_and(sign.any(-1), (~sign).any(-1))
    cells = np.argwhere(active)  # [Na, 3] (z, y, x)
    if len(cells) == 0:
        return np.zeros((0, 3)), np.zeros((0, 4), np.int64)

    # vertex per active cell: centroid of edge crossings
    verts = np.zeros((len(cells), 3))
    cvals = cs[active]  # [Na, 8]
    for ei, (a, b) in enumerate(_EDGES):
        fa, fb = cvals[:, a], cvals[:, b]
        cross = (fa < 0) != (fb < 0)
        t = np.where(cross, fa / np.where(fa == fb, 1.0, fa - fb), 0.0)
        pa = _CORNERS[a][None].astype(np.float64)
        pb = _CORNERS[b][None].astype(np.float64)
        verts += np.where(cross[:, None], pa + t[:, None] * (pb - pa), 0.0)
    ncross = np.zeros(len(cells))
    for a, b in _EDGES:
        ncross += ((cvals[:, a] < 0) != (cvals[:, b] < 0))
    verts /= np.maximum(ncross, 1)[:, None]
    verts = verts + cells  # (z, y, x) in grid units

    cell_index = -np.ones((nz - 1, ny - 1, nx - 1), np.int64)
    cell_index[tuple(cells.T)] = np.arange(len(cells))

    # quads: for each grid edge with a sign change, connect the 4 cells
    # sharing that edge
    quads = []
    for axis in range(3):  # edge direction (z=0, y=1, x=2)
        # edge from node p to p+e_axis; the 4 adjacent cells are offset by
        # -1/0 in the two other axes, taken in CYCLIC order — sorted order
        # flips the middle-axis (y) quad family's winding relative to the
        # x/z families (odd permutation), producing an inconsistently
        # oriented mesh
        o1, o2 = (axis + 1) % 3, (axis + 2) % 3
        s0 = inside
        shifted = np.roll(inside, -1, axis=axis)
        idx = [slice(None)] * 3
        idx[axis] = slice(0, -1)
        change = (s0 != shifted)[tuple(idx)]
        nodes = np.argwhere(change)
        for p in nodes:
            cell_ids = []
            ok = True
            for d1 in (-1, 0):
                for d2 in (-1, 0):
                    c = p.copy()
                    c[o1] += d1
                    c[o2] += d2
                    if (c < 0).any() or c[0] >= nz - 1 or c[1] >= ny - 1 \
                            or c[2] >= nx - 1:
                        ok = False
                        break
                    ci = cell_index[tuple(c)]
                    if ci < 0:
                        ok = False
                        break
                    cell_ids.append(ci)
                if not ok:
                    break
            if not ok:
                continue
            # order as a loop: (-1,-1), (-1,0), (0,0), (0,-1)
            a, b, cq, d = cell_ids[0], cell_ids[1], cell_ids[3], cell_ids[2]
            # orient toward the negative side
            if inside[tuple(p)]:
                quads.append((a, b, cq, d))
            else:
                quads.append((d, cq, b, a))
    quads = np.asarray(quads, np.int64).reshape(-1, 4)
    if close_boundary:
        verts = verts - 1.0  # undo the pad offset
    # to physical xyz
    sp = np.asarray(spacing)
    xyz = np.stack([verts[:, 2] * sp[2], verts[:, 1] * sp[1],
                    verts[:, 0] * sp[0]], axis=-1)
    return xyz, quads


def write_obj(path, vertices, faces):
    """Wavefront OBJ (1-based indices; tri or quad faces)."""
    with open(path, "w") as fh:
        for v in vertices:
            fh.write("v %.6f %.6f %.6f\n" % tuple(v))
        for f in faces:
            fh.write("f " + " ".join(str(int(i) + 1) for i in f) + "\n")
    return path


def field_to_obj(path, field, level=0.5, spacing=None):
    """One-call chi/SDF isosurface -> OBJ (the reference IBN_3D.py:36-69
    marching-cubes + trimesh workflow)."""
    field = np.asarray(field)
    if spacing is None:
        spacing = tuple(1.0 / max(1, s - 1) for s in field.shape)
    verts, quads = surface_nets(field, level=level, spacing=spacing)
    return write_obj(path, verts, quads)
