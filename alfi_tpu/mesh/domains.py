"""Benchmark-domain mesh generators.

The reference ships Gmsh meshes for its backwards-facing-step and DFG
problems (/root/reference/examples/bfs2d/backwards-facing-step.geo,
bfs3d/backwards-facing-step-3d.geo, dfg/dfg.geo); the JAX-native design
generates equivalent block-structured simplicial meshes directly (the
``gmsh_read`` path still accepts external .msh files).  Boundary tags
match the reference's physical ids:

* bfs2d: 1 = inflow (x=0), 2 = no-slip walls, 3 = outflow (x=10)
* bfs3d: 1 = inflow (x=0), 2 = outflow (x=10), 3 = no-slip
* dfg:   1 = inflow (x=0), 2 = walls, 3 = cylinder, 4 = outflow
"""

from __future__ import annotations

import numpy as np

from .core import Mesh


def _grid_tris(keepmask, nx, ny, vid):
    """Triangulate kept unit squares of an (nx, ny) cell grid ("left"
    diagonals)."""
    cells = []
    for i in range(nx):
        for j in range(ny):
            if not keepmask[i, j]:
                continue
            a, b = vid[i, j], vid[i + 1, j]
            c, d = vid[i + 1, j + 1], vid[i, j + 1]
            cells.append([a, b, c])
            cells.append([a, c, d])
    return np.array(cells)


def _structured_2d(nx, ny, Lx, Ly, keep):
    xs = np.linspace(0, Lx, nx + 1)
    ys = np.linspace(0, Ly, ny + 1)
    vid = -np.ones((nx + 1, ny + 1), dtype=np.int64)
    keepmask = np.zeros((nx, ny), dtype=bool)
    for i in range(nx):
        for j in range(ny):
            xm = 0.5 * (xs[i] + xs[i + 1])
            ym = 0.5 * (ys[j] + ys[j + 1])
            keepmask[i, j] = keep(xm, ym)
    used = np.zeros((nx + 1, ny + 1), dtype=bool)
    for i in range(nx):
        for j in range(ny):
            if keepmask[i, j]:
                used[i:i + 2, j:j + 2] = True
    verts = []
    for i in range(nx + 1):
        for j in range(ny + 1):
            if used[i, j]:
                vid[i, j] = len(verts)
                verts.append([xs[i], ys[j]])
    cells = _grid_tris(keepmask, nx, ny, vid)
    return np.array(verts), cells


def bfs2d_mesh(n=4):
    """Backwards-facing step, [0,10]x[0,2] minus the step [0,1]x[0,1];
    n = cells per unit length (reference meshes: coarse03..coarse12)."""
    eps = 1e-9
    verts, cells = _structured_2d(
        10 * n, 2 * n, 10.0, 2.0, lambda x, y: (x > 1) or (y > 1))

    def tagger(m):
        t = np.zeros(len(m), dtype=np.int64)
        on_noslip = (
            (np.abs(m[:, 1]) < eps) | (np.abs(m[:, 1] - 2) < eps)
            | ((np.abs(m[:, 0] - 1) < eps) & (m[:, 1] < 1))
            | ((np.abs(m[:, 1] - 1) < eps) & (m[:, 0] < 1))
        )
        t[on_noslip] = 2
        t[np.abs(m[:, 0]) < eps] = 1
        t[np.abs(m[:, 0] - 10) < eps] = 3
        return t

    return Mesh(verts, cells, facet_markers_from=(tagger,), name="bfs2d")


def bfs3d_mesh(n=2):
    """3D backwards-facing step, [0,10]x[0,2]x[0,1] minus
    [0,1]x[0,1]x[0,1] (reference geometry: Lstep=1, step height Ly/2)."""
    eps = 1e-9
    nx, ny, nz = 10 * n, 2 * n, n
    xs = np.linspace(0, 10, nx + 1)
    ys = np.linspace(0, 2, ny + 1)
    zs = np.linspace(0, 1, nz + 1)

    def keep(i, j, k):
        xm = 0.5 * (xs[i] + xs[i + 1])
        ym = 0.5 * (ys[j] + ys[j + 1])
        return (xm > 1) or (ym > 1)

    vid = -np.ones((nx + 1, ny + 1, nz + 1), dtype=np.int64)
    used = np.zeros_like(vid, dtype=bool)
    boxes = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                if keep(i, j, k):
                    boxes.append((i, j, k))
                    used[i:i + 2, j:j + 2, k:k + 2] = True
    verts = []
    for i in range(nx + 1):
        for j in range(ny + 1):
            for k in range(nz + 1):
                if used[i, j, k]:
                    vid[i, j, k] = len(verts)
                    verts.append([xs[i], ys[j], zs[k]])
    # 6-tet split of each kept box (Kuhn triangulation: consistent,
    # conforming across neighbours)
    perms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
             (2, 1, 0)]
    cells = []
    for (i, j, k) in boxes:
        corner = np.array([i, j, k])
        for p in perms:
            path = [corner.copy()]
            c = corner.copy()
            for ax in p:
                c = c.copy()
                c[ax] += 1
                path.append(c)
            cells.append([vid[tuple(pt)] for pt in path])
    cells = np.array(cells)

    def tagger(m):
        t = np.zeros(len(m), dtype=np.int64)
        on_noslip = (
            (np.abs(m[:, 1]) < eps) | (np.abs(m[:, 1] - 2) < eps)
            | (np.abs(m[:, 2]) < eps) | (np.abs(m[:, 2] - 1) < eps)
            | ((np.abs(m[:, 0] - 1) < eps) & (m[:, 1] < 1))
            | ((np.abs(m[:, 1] - 1) < eps) & (m[:, 0] < 1))
        )
        t[on_noslip] = 3
        t[np.abs(m[:, 0]) < eps] = 1
        t[np.abs(m[:, 0] - 10) < eps] = 2
        return t

    return Mesh(verts, cells, facet_markers_from=(tagger,), name="bfs3d")


def dfg2d_mesh(n=40):
    """DFG 2D-1 cylinder benchmark channel: [0, 2.2]x[0, 0.41], cylinder
    centre (0.2, 0.2) radius 0.05 (dfg.geo).  Structured grid with the
    cylinder cut out and its rim vertices snapped onto the circle (the
    geometry is polygonal — like the reference's linear gmsh mesh under
    refinement).  n = cells per unit length."""
    cx, cy, r = 0.2, 0.2, 0.05
    eps = 1e-9
    nx = int(round(2.2 * n))
    ny = int(round(0.41 * n))

    def keep(x, y):
        return (x - cx) ** 2 + (y - cy) ** 2 > r * r

    verts, cells = _structured_2d(nx, ny, 2.2, 0.41, keep)
    # snap rim vertices onto the circle: used vertices strictly inside
    # the cylinder (corners of kept squares that dip in) move OUTWARD to
    # the circle, which cannot invert the surrounding kept triangles
    d = np.sqrt((verts[:, 0] - cx) ** 2 + (verts[:, 1] - cy) ** 2)
    h = max(2.2 / nx, 0.41 / ny)
    rim = d < r - 1e-12
    safe = np.maximum(d[rim], 1e-12)
    verts[rim, 0] = cx + (verts[rim, 0] - cx) * r / safe
    verts[rim, 1] = cy + (verts[rim, 1] - cy) * r / safe

    def tagger(m):
        # default 3 = cylinder: any exterior facet NOT on the channel
        # rectangle is part of the (polygonal) cylinder rim; interior
        # facets also get 3 but boundary_facets() intersects with the
        # exterior set so that is harmless
        t = np.full(len(m), 3, dtype=np.int64)
        t[(np.abs(m[:, 1]) < eps) | (np.abs(m[:, 1] - 0.41) < eps)] = 2
        t[np.abs(m[:, 0]) < eps] = 1
        t[np.abs(m[:, 0] - 2.2) < eps] = 4
        return t

    return Mesh(verts, cells, facet_markers_from=(tagger,), name="dfg2d")
