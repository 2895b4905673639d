"""Geometric (lexicographic) entity numbering — the sliced-patch enabler.

Table-driven FEM index ops are random gathers, far below the HBM
roofline.  The escape hatch is STRUCTURE: on the generated benchmark meshes (uniformly refined
structured triangulations — ldc2d, the bench protocol, the headline
robustness sweeps) a lexicographic entity numbering makes every patch-
smoother index table AFFINE in the seed-grid coordinates, so the hot
gather/scatter becomes dense strided slices at full HBM bandwidth
(mg/structured.py).

This module provides the numbering itself, applied mesh-wide:

* vertices sorted by (y, x) — resp. (z, y, x) — of their coordinates;
* 2D facets (= edges) sorted by (direction class, y_mid, x_mid), which
  on a structured grid groups the three edge families (horizontal,
  vertical, diagonal) into contiguous lex-ordered plane blocks.

The numbering is a pure permutation: every consumer in the repo
(element tables, BC facet markers, transfer point location, patch
construction, distributed decomposition) is numbering-agnostic, so
correctness is unaffected; only the EXPLOITABILITY of the index tables
changes.  It deliberately applies to ANY 2D mesh (gmsh imports
included) — unstructured meshes simply get a deterministic geometric
order that downstream structure detection (mg/structured.py) declines.

Gated by ALFI_TPU_GEOM_NUMBERING (default on).  Replaces no reference
component: Firedrake/PETSc renumber for cache locality via DMPlex
permutations (the reference inherits that); here the same hook is used
to expose slice structure to XLA instead.
"""

from __future__ import annotations

import os

import numpy as np


def geom_numbering_enabled():
    return os.environ.get("ALFI_TPU_GEOM_NUMBERING", "1") == "1"


def vertex_lex_perm(vertices):
    """new-order list: ``perm[k]`` = old id of the k-th vertex in
    (y, x) / (z, y, x) lexicographic coordinate order (ties broken by
    old id, so the permutation is deterministic)."""
    v = np.asarray(vertices)
    keys = tuple(v[:, i] for i in range(v.shape[1]))  # x fastest
    return np.lexsort((np.arange(v.shape[0]),) + keys)


def renumber_vertices(vertices, cells, perm, *extra_vertex_tuples):
    """Apply a vertex permutation: returns (vertices2, cells2,
    *remapped extras).  ``perm`` is new-order->old-id (from
    vertex_lex_perm); extras are arrays of OLD vertex ids of any shape
    (e.g. refine's child facet tuples)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    out = [vertices[perm], inv[cells]]
    for t in extra_vertex_tuples:
        out.append(inv[np.asarray(t)])
    return tuple(out)


def geom_numbering_3d_enabled():
    """3D entity numbering is OPT-IN (ALFI_TPU_GEOM_NUMBERING_3D=1):
    flipping it changes the checkpoint numbering tag, which would
    orphan every existing 3D continuation checkpoint mid-round."""
    return os.environ.get("ALFI_TPU_GEOM_NUMBERING_3D") == "1"


def facet_geom_perm(vertices, facet_vertices):
    """new-order list for 2D facets (= edges): sort by (direction
    class, y_mid, x_mid).  The direction class is the edge angle folded
    to [0, pi) and rounded — on a structured grid this yields exactly
    one contiguous, lex-ordered block per edge family."""
    fv = np.asarray(facet_vertices)
    a = vertices[fv[:, 0]]
    b = vertices[fv[:, 1]]
    d = b - a
    ang = np.round(np.arctan2(d[:, 1], d[:, 0]) % np.pi, 9)
    mid = 0.5 * (a + b)
    return np.lexsort((np.arange(fv.shape[0]), mid[:, 0], mid[:, 1],
                       ang))


def entity_geom_perm(vertices, entity_vertices):
    """Generic geometric entity order in any dimension: sort by
    (direction-class key, z_mid, y_mid, x_mid).

    The direction class of an entity is its normalised, sign-folded
    span: for an edge the unit direction vector, for a triangular face
    the unit normal — rounded so exact-arithmetic families on a
    structured grid collapse to identical keys, producing one
    contiguous lex-ordered block per entity family (the 3D analogue of
    :func:`facet_geom_perm`, enabling the sliced patch tables of
    mg/structured.py on generated box meshes)."""
    ev = np.asarray(entity_vertices)
    n, k = ev.shape
    pts = vertices[ev]  # (n, k, dim)
    mid = pts.mean(axis=1)
    if k == 2:
        dvec = pts[:, 1] - pts[:, 0]
    else:  # triangle: normal spans the direction class
        dvec = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
    nrm = np.linalg.norm(dvec, axis=1, keepdims=True)
    dvec = dvec / np.maximum(nrm, 1e-300)
    # fold sign: first nonzero component positive
    sgn = np.ones(n)
    for c in range(dvec.shape[1] - 1, -1, -1):
        nz = np.abs(dvec[:, c]) > 1e-9
        sgn = np.where(nz, np.sign(dvec[:, c]), sgn)
    dvec = np.round(dvec * sgn[:, None], 9)
    keys = [np.arange(n)]
    keys += [mid[:, c] for c in range(mid.shape[1])]  # x fastest
    keys += [dvec[:, c] for c in range(dvec.shape[1])]
    return np.lexsort(tuple(keys))
