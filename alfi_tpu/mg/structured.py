"""Sliced patch gather/scatter on structured meshes — gathers at HBM speed.

The additive star-patch apply is three steps: gather the patch-local
residual rows, batched-GEMV against the stored patch inverses, scatter
the correction back (the reference's equivalent loop is PCPatch's
scatter/solve/gather, /root/reference/alfi/solver.py:313-344 +
relaxation.py).  The gathers are random fetches; on structured meshes
they can be dense slices instead.

On the generated benchmark meshes the geometric entity numbering
(mesh/renumber.py) makes the patch dof table AFFINE over the interior
seed grid: flat dof of slot-group j of the patch at grid position
(x, y) is

    dofs[p(x, y), j*d + t]  =  s_j + by_j * y + d * x + t

so gathering slot j for ALL interior patches is a contiguous slice of
the residual vector reshaped to (ny, by_j) — a dense DMA instead of
ny*nx random fetches — and the scatter-add transpose is the same slices
as padded dense adds.  Boundary patches (a 1D fringe, a few percent of
the total) keep the generic table path.

This module is pure detection + closure construction: it makes NO
assumptions about how the mesh was generated.  `detect` verifies the
affine property exactly, slot by slot, against the actual dof table and
declines (returns None) on any mismatch — gmsh imports, distributed
block-local patchsets and Schöberl cell patches all fall back to the
generic gather/scatter unchanged.

Coverage (round 5):
 * 2D structured grids — pass 1, one class of max-size star patches.
 * 3D structured tet lattices — pass 2, per-parity classes
   (z%2, y%2, x%2): the lattice repeats with period 2, so only
   same-parity interior stars are translation-equivalent.  Needs the
   3D geometric numbering (mesh/renumber.py,
   ALFI_TPU_GEOM_NUMBERING_3D=1 — opt-in because the checkpoint
   numbering tag changes).
 * 2D bary (Alfeld) meshes / SV MACROSTAR patches — pass 2 again:
   centroids are appended in parent-cell order, which repeats with
   period 2 across the macro grid, so all four (y%2, x%2) interior
   classes are exactly affine (measured, stride 2).  Six of the 31
   slot families are numbered Y-FASTEST (edge/centroid families whose
   geometric sort runs column-major) — those slots use the swapped-
   axis window (_Block.swapped) instead of declining.
"""

from __future__ import annotations

import os

import numpy as np


def struct_patch_enabled():
    """Whether patch solvers take the sliced path where :func:`detect`
    finds one: opt in with ALFI_TPU_STRUCT_PATCH=1.  Off by default: on
    the GPU it was slower with either patch factor (PERF.md, backend
    A/B)."""
    return os.environ.get("ALFI_TPU_STRUCT_PATCH") == "1"


class _Block:
    """One sliced patch CLASS: a full box of translation-equivalent
    interior patches.  2D structured triangle grids have exactly one
    class; 3D structured tet lattices have up to eight parity classes
    (z%2, y%2, x%2) with different star sizes — each class gets its own
    affine slot table.  ``sentinel[j]`` marks slot groups that are pure
    padding for this class (patch tables are padded to the global m
    with dof == nflat): they gather zeros and scatter nothing."""

    def __init__(self, extents, starts, strides, sentinel,
                 swapped=None):
        self.extents = tuple(int(e) for e in extents)
        self.ni = int(np.prod(self.extents))
        self.starts = starts
        self.strides = strides
        self.sentinel = sentinel
        #: per-slot flag (2D only): the slot's dof numbering is
        #: Y-FASTEST (x-stride covers the y-window instead of the
        #: usual x-fastest nesting) — gather/scatter run the window
        #: reshape in (x, y) order and transpose.  SV bary macrostar
        #: edge/centroid dof families produce these (6 of 31 slots).
        self.swapped = (np.zeros(len(starts), dtype=bool)
                        if swapped is None else swapped)

    def window_len(self, j):
        """Flat window length of slot j's dense slice."""
        if self.swapped[j]:
            return self.extents[1] * int(self.strides[j, 1])
        return self.extents[0] * int(self.strides[j, 0])


class StructuredLayout:
    """Detected slice structure of a PatchSet (host-side, static).

    order    (np,)  patch permutation: sliced patches first (class by
                    class, each in (z,) (y, x) lex order), fringe after
    ni       int    total sliced patches = sum of block ni
    blocks   list   per-class _Block slot tables
    pad      int    rows to append to the flat vector so every outer
                    slice [s, s + n_outer * stride_outer) is in range
    """

    def __init__(self, order, blocks, pad):
        self.order = order
        self.blocks = blocks
        self.ni = sum(b.ni for b in blocks)
        self.pad = pad

    # single-class accessors (2D consumers/tests)
    @property
    def extents(self):
        return self.blocks[0].extents

    @property
    def ny(self):
        return self.blocks[0].extents[-2]

    @property
    def nx(self):
        return self.blocks[0].extents[-1]

    @property
    def starts(self):
        return self.blocks[0].starts

    @property
    def strides(self):
        return self.blocks[0].strides

    @property
    def bys(self):
        return self.blocks[0].strides[:, -2]


def _grid_coords(points):
    """Integer grid coordinates of points on a uniform grid (any
    dimension), or None if the points do not sit on one."""
    out = []
    for c in range(points.shape[1]):
        v = points[:, c]
        u = np.unique(v)
        if u.size < 2:
            return None
        h = np.diff(u).min()
        if h <= 0:
            return None
        g = (v - u[0]) / h
        gi = np.rint(g).astype(np.int64)
        if np.abs(g - gi).max() > 1e-8:
            return None
        out.append(gi)
    return out


def _solve_block(patchset, idx, coords):
    """Affine/sentinel slot solve for one candidate class.

    The dof of component t of slot group j of the patch at class-grid
    position (z, y, x) must satisfy EXACTLY

        dofs = s_j + bz_j*z + by_j*y + d*x_step*x ... — we absorb the
    grid step into the strides by using the RELATIVE class coordinates
    directly (a parity class advances 2 lattice steps per unit), so the
    solved x-stride is d * (lattice dofs per class step).

    Returns (lex_order_of_idx, _Block) or None; every check is against
    the actual dof table, so anything non-affine declines."""
    m, d = patchset.m, patchset.space_d
    dim = len(coords)
    exts = [int(c.max() - c.min() + 1) for c in coords]
    if idx.size != int(np.prod(exts)):
        return None
    rel = [np.asarray(c - c.min(), dtype=np.int64) for c in coords]
    bitmap = np.zeros(exts, dtype=bool)
    bitmap[tuple(rel)] = True
    if not bitmap.all():
        return None
    # class patches in (z, y, x) lex order, x fastest
    o = np.lexsort(tuple(rel[::-1]))
    lex = idx[o]
    R = [r[o] for r in rel]
    D = patchset.dofs[lex].astype(np.int64)  # (ni, m)
    nflat = patchset.nflat
    md = m // d
    starts = np.zeros(md, dtype=np.int64)
    strides = np.zeros((md, dim), dtype=np.int64)
    sentinel = np.zeros(md, dtype=bool)
    swapped = np.zeros(md, dtype=bool)
    # every axis stride is solved per slot, x included: a parity class
    # steps 2 lattice units per class step, so sx is d * (flat dofs per
    # class step), not necessarily d
    for j in range(md):
        G = D[:, j * d:(j + 1) * d]
        if (G == nflat).all():
            sentinel[j] = True
            continue
        base = G[:, 0]
        origin = np.all([R[a] == 0 for a in range(dim)], axis=0)
        if not (base[origin] == base[origin][0]).all():
            return None
        s = int(base[origin][0])
        rr = base - s
        if dim == 2:
            # solve both strides from unit probes, then accept either
            # axis orientation: x-fastest (the standard nesting) or
            # y-fastest (swapped — SV bary macrostar edge/centroid
            # families), as long as the outer stride covers the whole
            # inner window so the slot is one dense strided slice.
            ny, nx = exts
            got = _solve_strides_2d(rr, R, exts, d)
            if got is None:
                return None
            sty, stx, swap = got
            if not np.array_equal(rr, stx * R[1] + sty * R[0]):
                return None
            if not np.array_equal(
                    G, base[:, None] + np.arange(d)[None, :]):
                return None
            starts[j] = s
            strides[j, :] = (sty, stx)
            swapped[j] = swap
            continue
        expect = np.zeros_like(rr)
        lower = d  # x-stride >= d; each outer covers the inner window
        sts = []
        for a in range(dim - 1, -1, -1):  # X, Y, then (3D) Z
            if exts[a] == 1:
                # degenerate axis (a 1-thick interior class slab):
                # stride never used; pick the window bound
                sts.append(lower)
                continue
            unit = np.all(
                [R[b] == (1 if b == a else 0) for b in range(dim)],
                axis=0)
            if not unit.any():
                return None
            st = int((rr - expect)[unit][0])
            if st < lower:
                return None
            sts.append(st)
            expect = expect + st * R[a]
            lower = st * exts[a]
        if not np.array_equal(rr, expect):
            return None
        # the d components of the group must be consecutive
        if not np.array_equal(G, base[:, None] + np.arange(d)[None, :]):
            return None
        starts[j] = s
        strides[j, :] = sts[::-1]  # (z,) (y,) x — x-stride >= d
    if sentinel.all():
        return None
    # sentinel slots: park their (empty) slice window in the pad region
    starts[sentinel] = nflat
    return lex, _Block(exts, starts, strides, sentinel, swapped)


def _solve_strides_2d(rr, R, exts, d):
    """(sty, stx, swapped) for one 2D slot, or None.

    Degenerate axes (extent 1) take the other axis's window as their
    stride so the flat window formula stays valid."""
    ny, nx = exts

    def unit_stride(a):
        unit = np.all(
            [R[b] == (1 if b == a else 0) for b in range(2)], axis=0)
        if not unit.any():
            return None
        return int(rr[unit][0])

    if nx == 1 and ny == 1:
        return d, d, False
    if nx == 1:
        sty = unit_stride(0)
        if sty is None or sty < d:
            return None
        return sty, sty * ny, False
    if ny == 1:
        stx = unit_stride(1)
        if stx is None or stx < d:
            return None
        return stx * nx, stx, False
    stx = unit_stride(1)
    sty = unit_stride(0)
    if stx is None or sty is None:
        return None
    if stx >= d and sty >= stx * nx:
        return sty, stx, False
    if sty >= d and stx >= sty * ny:
        return sty, stx, True
    return None


def detect(patchset):
    """Affine-slice detection; StructuredLayout or None.

    Pass 1 (2D fast path): all max-size patches as ONE class.
    Pass 2 (3D lattices): per-parity classes (z%2, y%2, x%2) — the
    structured tet lattice has translation-equivalent stars only
    within a parity class."""
    seeds = getattr(patchset, "seed_points", None)
    m, d = patchset.m, patchset.space_d
    if (seeds is None or seeds.ndim != 2 or seeds.shape[1] not in (2, 3)
            or m == 0 or d < 1 or m % d):
        return None
    g = _grid_coords(np.asarray(seeds))
    if g is None:
        return None
    dim = len(g)
    # outer-major coordinates: (z,) y, x
    gco = [np.asarray(g[c], dtype=np.int64)
           for c in range(dim - 1, -1, -1)]

    def finish(pairs):
        if not pairs:
            return None
        lexes = [p[0] for p in pairs]
        blocks = [p[1] for p in pairs]
        sliced = np.concatenate(lexes)
        rest = np.setdiff1d(np.arange(patchset.npatches), sliced,
                            assume_unique=False)
        order = np.concatenate([sliced, rest])
        pad = 1
        for b in blocks:
            for j in range(len(b.starts)):
                if not b.sentinel[j]:
                    pad = max(pad, int(b.starts[j]) + b.window_len(j)
                              - patchset.nflat)
        return StructuredLayout(order, blocks, max(pad, 1))

    # pass 1: single class of max-size patches (2D structured grids)
    idx = np.where(patchset.sizes == m)[0]
    if idx.size >= 2 ** dim:
        got = _solve_block(patchset, idx, [c[idx] for c in gco])
        if got is not None:
            return finish([got])
    # pass 2: parity classes; only LATTICE-interior members are
    # translation-equivalent (boundary stars are BC-truncated), and
    # only within a parity class.  3D: the structured tet lattice
    # repeats with period 2.  2D: bary (Alfeld) meshes repeat with
    # period 2 as well — centroid vertices are appended in parent-CELL
    # order, which alternates triangle orientation across the grid —
    # so the SV macrostar family slices here too (measured: all four
    # (y%2, x%2) classes are exactly affine at stride 2,
    # VERDICT r4 item 3).
    interior = np.ones(patchset.npatches, dtype=bool)
    for c in gco:
        interior &= (c > c.min()) & (c < c.max())
    pairs = []
    par = np.zeros_like(gco[0])
    for c in gco:
        par = par * 2 + (c % 2)
    for p in range(2 ** dim):
        cls = np.where((par == p) & interior)[0]
        if cls.size < 2:
            continue
        # all interior members of a class must agree in size
        sz = patchset.sizes[cls]
        if not (sz == sz[0]).all():
            continue
        got = _solve_block(
            patchset, cls, [(c[cls] - c[cls].min()) // 2 for c in gco])
        if got is not None:
            pairs.append(got)
    total = sum(p[1].ni for p in pairs)
    # worth reordering once a solid fraction is sliced (the fringe is
    # surface-scaling, so this passes at production sizes)
    if total < 0.3 * patchset.npatches:
        return None
    return finish(pairs)


def reorder_patchset(patchset, order):
    """Permute PatchSet rows in place (interior grid first)."""
    for name in ("dofs", "active", "cells", "l2p", "sizes",
                 "seed_points"):
        arr = getattr(patchset, name, None)
        if arr is not None:
            setattr(patchset, name, arr[order])


def gather_scatter(patchset, layout):
    """Slice-based (gather, scatter) pair in the PATCH-MINOR (m, np)
    vector layout (feeds _ExplicitInverseFactorization.solve_t).
    ``patchset`` must already be reordered by ``layout.order``."""
    import jax.numpy as jnp

    from ..utils.scatter import make_gather_sum

    m, d = patchset.m, patchset.space_d
    md = m // d
    ni = layout.ni
    blocks = layout.blocks
    pad = int(layout.pad)
    nflat = patchset.nflat
    nb = patchset.npatches - ni
    if nb:
        dofs_b_np = patchset.dofs[ni:]  # (nb, m), pad = nflat
        dofs_b = jnp.asarray(dofs_b_np)
        active_b = jnp.asarray(patchset.active[ni:])
        # compact the boundary scatter: a gather-sum with nout=nflat
        # would pay a permutation gather over the WHOLE vector for a
        # fringe that touches ~1% of it (measured 3 ms at nref=3);
        # instead sum into the ~nbd touched dofs and do ONE small
        # sorted-unique scatter-add
        bd = np.unique(dofs_b_np[dofs_b_np < nflat])
        pos = np.searchsorted(bd, np.clip(dofs_b_np, 0, nflat - 1))
        pos = np.where(dofs_b_np < nflat, pos, bd.size)
        bsum = make_gather_sum(pos, bd.size)
        bd_j = jnp.asarray(bd)

    def _gather_block(rpad, b):
        """(m, ni_b) for one class: slot windows are dense slices; the
        per-position d components sit at stride sx >= d."""
        exts = b.extents
        dim = len(exts)
        nx = exts[-1]
        parts = []
        for j in range(md):
            if b.sentinel[j]:
                parts.append(jnp.zeros((d, b.ni), dtype=rpad.dtype))
                continue
            s = int(b.starts[j])
            row = [int(v) for v in b.strides[j]]
            sx = row[-1]
            if dim == 2:
                by = row[0]
                ny = exts[0]
                if b.swapped[j]:
                    # y-fastest slot: window is x-major — reshape in
                    # (nx, ny) order, transpose back to patch lex order
                    seg = rpad[s:s + nx * sx].reshape(nx, sx)
                    seg = seg[:, :ny * by].reshape(nx, ny, by)[:, :, :d]
                    seg = jnp.swapaxes(seg, 0, 1)  # (ny, nx, d)
                else:
                    seg = rpad[s:s + ny * by].reshape(ny, by)
                    seg = seg[:, :nx * sx].reshape(ny, nx, sx)[:, :, :d]
            else:
                bz, by = row[0], row[1]
                nz, ny = exts[0], exts[1]
                seg = rpad[s:s + nz * bz].reshape(nz, bz)
                seg = seg[:, :ny * by].reshape(nz, ny, by)
                seg = seg[:, :, :nx * sx].reshape(nz, ny, nx, sx)[
                    ..., :d]
            parts.append(seg.reshape(b.ni, d).T)
        return jnp.concatenate(parts, axis=0)  # (m, ni_b)

    def _scatter_block(xi, b, total, dtype):
        exts = b.extents
        dim = len(exts)
        nx = exts[-1]
        out = jnp.zeros((total,), dtype=dtype)
        for j in range(md):
            if b.sentinel[j]:
                continue
            s = int(b.starts[j])
            row = [int(v) for v in b.strides[j]]
            sx = row[-1]
            if dim == 2:
                by = row[0]
                ny = exts[0]
                if b.swapped[j]:
                    # y-fastest slot: build the x-major window
                    seg = xi[j * d:(j + 1) * d].T.reshape(ny, nx, d)
                    seg = jnp.swapaxes(seg, 0, 1)  # (nx, ny, d)
                    seg = jnp.pad(seg, ((0, 0), (0, 0), (0, by - d)))
                    seg = seg.reshape(nx, ny * by)
                    seg = jnp.pad(seg, ((0, 0), (0, sx - ny * by)))
                    win = nx * sx
                else:
                    seg = xi[j * d:(j + 1) * d].T.reshape(ny, nx, d)
                    seg = jnp.pad(seg, ((0, 0), (0, 0), (0, sx - d)))
                    seg = seg.reshape(ny, nx * sx)
                    seg = jnp.pad(seg, ((0, 0), (0, by - nx * sx)))
                    win = ny * by
            else:
                bz, by = row[0], row[1]
                nz, ny = exts[0], exts[1]
                seg = xi[j * d:(j + 1) * d].T.reshape(nz, ny, nx, d)
                seg = jnp.pad(seg,
                              ((0, 0), (0, 0), (0, 0), (0, sx - d)))
                seg = seg.reshape(nz, ny, nx * sx)
                seg = jnp.pad(seg, ((0, 0), (0, 0), (0, by - nx * sx)))
                seg = seg.reshape(nz, ny * by)
                seg = jnp.pad(seg, ((0, 0), (0, bz - ny * by)))
                win = nz * bz
            out = out + jnp.pad(
                seg.reshape(win), (s, total - s - win))
        return out

    def gather(r_flat):
        rpad = jnp.concatenate(
            [r_flat, jnp.zeros((pad + 1,), dtype=r_flat.dtype)])
        xi = jnp.concatenate([_gather_block(rpad, b) for b in blocks],
                             axis=1)  # (m, ni)
        if not nb:
            return xi
        xb = rpad[:nflat + 1][dofs_b].T  # (m, nb)
        return jnp.concatenate([xi, xb], axis=1)

    def scatter(xp, dtype):
        total = nflat + pad
        out = jnp.zeros((total,), dtype=dtype)
        off = 0
        for b in blocks:
            out = out + _scatter_block(
                xp[:, off:off + b.ni].astype(dtype), b, total, dtype)
            off += b.ni
        out = out[:nflat]
        if nb:
            xb = jnp.where(active_b, xp[:, ni:].T, 0).astype(dtype)
            out = out.at[bd_j].add(
                bsum(xb), indices_are_sorted=True, unique_indices=True)
        return out

    return gather, scatter
