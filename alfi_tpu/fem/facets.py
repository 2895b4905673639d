"""Interior-facet integration machinery.

The reference gets dS-integrals (Burman edge stabilisation,
/root/reference/alfi/stabilisation.py:156-162) from TSFC-generated
interior-facet kernels; here the JAX-native design is: a SMALL set of
"configurations" — (ordered local vertex indices of the facet within the
cell) — is tabulated once as constants, and every facet side just stores
its configuration id.  Facet quadrature points are parametrised by the
facet's GLOBAL sorted vertex tuple, so the q-th point is the same physical
point from both sides (no cross-side point matching needed at runtime).
"""

from __future__ import annotations

import itertools
from math import factorial

import jax.numpy as jnp
import numpy as np

from ..config import real_dtype
from .element import simplex_vertices
from .quadrature import simplex_quadrature


class InteriorFacets:
    """Static tabulations + topology for dS integrals of one scalar space.

    Attributes (jnp):
    cells (nif, 2), config (nif, 2), normal (nif, d) [outward from side 0],
    scale (nif,) [physical facet measure / reference measure],
    harea (nif,) [FacetArea in 2D, sqrt(FacetArea) in 3D — the reference's
    Burman h, /root/reference/alfi/stabilisation.py:146-151],
    w (nq,), tab (nconf, nq, nloc), gtab (nconf, nq, nloc, d).
    """

    def __init__(self, space, quad_degree):
        mesh = space.mesh
        elem = space.element
        d = mesh.dim
        self.dim = d
        fidx = mesh.interior_facets
        self.facets = fidx
        nif = len(fidx)
        self.nif = nif

        pts, wts = simplex_quadrature(d - 1, quad_degree)
        pts = np.atleast_2d(pts)
        if d - 1 == 1:
            pts = pts.reshape(-1, 1)
        nq = len(wts)
        self.nq = nq
        # barycentric coords of the quad points on the reference facet
        lam = np.hstack([1.0 - pts.sum(axis=1, keepdims=True), pts])

        # configurations: ordered d-tuples of distinct local vertex ids
        verts = simplex_vertices(d)
        configs = list(itertools.permutations(range(d + 1), d))
        cfg_lookup = {c: i for i, c in enumerate(configs)}
        tabs, gtabs = [], []
        for c in configs:
            ref_pts = lam @ verts[list(c)]
            tabs.append(elem.tabulate(ref_pts))
            gtabs.append(elem.tabulate_grad(ref_pts))
        self.tab = jnp.asarray(np.stack(tabs), dtype=real_dtype)
        self.gtab = jnp.asarray(np.stack(gtabs), dtype=real_dtype)
        self.w = jnp.asarray(wts, dtype=real_dtype)

        # per facet side: configuration id
        fv = mesh.facet_vertices[fidx]  # (nif, d) sorted global ids
        fcells = mesh.facet_cells[fidx]  # (nif, 2)
        cfg = np.zeros((nif, 2), dtype=np.int64)
        for s in range(2):
            cells = mesh.cells[fcells[:, s]]  # (nif, d+1)
            # local index of each facet vertex within the cell
            loc = np.argmax(cells[:, None, :] == fv[:, :, None], axis=2)
            keys = [tuple(row) for row in loc]
            cfg[:, s] = [cfg_lookup[kk] for kk in keys]
        self.cells = jnp.asarray(fcells)
        self.config = jnp.asarray(cfg)

        # geometry: normal outward from side 0, physical measure
        V = mesh.vertices[fv]  # (nif, d, d)
        if d == 2:
            t = V[:, 1] - V[:, 0]
            n = np.stack([t[:, 1], -t[:, 0]], axis=1)
            area = np.linalg.norm(t, axis=1)
        else:
            e1, e2 = V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]
            n = np.cross(e1, e2)
            area = 0.5 * np.linalg.norm(n, axis=1)
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        cent0 = mesh.vertices[mesh.cells[fcells[:, 0]]].mean(axis=1)
        mid = V.mean(axis=1)
        flip = np.einsum("fd,fd->f", n, cent0 - mid) > 0
        n[flip] *= -1.0
        self.normal = jnp.asarray(n, dtype=real_dtype)
        ref_measure = 1.0 / factorial(d - 1)
        self.scale = jnp.asarray(area / ref_measure, dtype=real_dtype)
        h = area if d == 2 else np.sqrt(area)
        self.harea = jnp.asarray(h, dtype=real_dtype)

    # ------------------------------------------------------------------
    def side_values(self, space_cell_dofs, jinv, u, s):
        """(values (nif, nq, d_val), physical grads (nif, nq, nloc, d),
        local dofs) for side s of every interior facet."""
        c = self.cells[:, s]
        cfg = self.config[:, s]
        dofs = space_cell_dofs[c]  # (nif, nloc)
        u_loc = u[dofs]
        tab = self.tab[cfg]  # (nif, nq, nloc)
        gtab = self.gtab[cfg]  # (nif, nq, nloc, d)
        gphys = jnp.einsum("fqle,fej->fqlj", gtab, jinv[c])
        if u.ndim == 1:
            vals = jnp.einsum("fql,fl->fq", tab, u_loc)
        else:
            vals = jnp.einsum("fql,fld->fqd", tab, u_loc)
        return vals, gphys, dofs
