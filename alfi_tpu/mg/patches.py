"""Vertex-star patch smoothers, batched.

JAX-native replacement for PETSc's PCPatch + the reference's topological
patch constructors (/root/reference/alfi/relaxation.py Star/MacroStar,
configured at /root/reference/alfi/solver.py:313-344).  Design per
SURVEY.md §7 stage 4:

* host: enumerate star(v) for every vertex — all unconstrained velocity
  dofs on entities CONTAINING v — pad to the max patch size, and
  precompute, per (patch, adjacent cell), the cell-local -> patch-local
  index map;
* device: patch operators are summed out of the SAME per-cell element
  tensors used everywhere else ("precompute_element_tensors"), factored
  with one batched LU, and applied additively (no partition of unity,
  matching patch_pc_patch_partition_of_unity False).

Padding goes to dump slots (row m of an (m+1)-sized accumulator, dof index
ndof of an (ndof+1)-sized vector) so every shape is static.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import index_dtype


def _csr_from_pairs(keys, vals, nkeys):
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    starts = np.searchsorted(keys, np.arange(nkeys + 1))
    return starts, vals


def _pad_csr(starts, vals, fill):
    n = len(starts) - 1
    counts = np.diff(starts)
    m = int(counts.max()) if n else 0
    out = np.full((n, m), fill, dtype=np.int64)
    idx = np.arange(len(vals)) - np.repeat(starts[:-1], counts)
    out[np.repeat(np.arange(n), counts), idx] = vals
    return out, counts


def star_patch_dofs(space, seed_vertices=None):
    """Scalar dofs in star(v) per vertex (padded), + adjacent cells.

    Returns (patch_dofs (np, m) padded with -1, sizes (np,),
             patch_cells (np, mc) padded with -1, cell_counts)."""
    mesh = space.mesh
    if seed_vertices is None:
        seed_vertices = np.arange(mesh.num_vertices, dtype=np.int64)
    nv = mesh.num_vertices

    pair_k, pair_d = [], []
    if space.n_per_vertex:
        pair_k.append(np.arange(nv, dtype=np.int64))
        pair_d.append(space.off_v + np.arange(nv, dtype=np.int64))
    npe = space.n_per_edge
    if npe:
        ev = space.mesh.edge_vertices if mesh.dim == 3 else mesh.facet_vertices
        ne = ev.shape[0]
        for j in range(ev.shape[1]):
            for t in range(npe):
                pair_k.append(ev[:, j].astype(np.int64))
                pair_d.append(space.off_e
                              + np.arange(ne, dtype=np.int64) * npe + t)
    npf = space.n_per_facet
    if npf:
        fv = mesh.facet_vertices
        nf = fv.shape[0]
        for j in range(fv.shape[1]):
            for t in range(npf):
                pair_k.append(fv[:, j].astype(np.int64))
                pair_d.append(space.off_f
                              + np.arange(nf, dtype=np.int64) * npf + t)
    npc = space.n_per_cell
    if npc:
        cells = mesh.cells
        nc = mesh.num_cells
        for j in range(cells.shape[1]):
            for t in range(npc):
                pair_k.append(cells[:, j].astype(np.int64))
                pair_d.append(space.off_c
                              + np.arange(nc, dtype=np.int64) * npc + t)
    keys = np.concatenate(pair_k)
    vals = np.concatenate(pair_d)
    starts, vals = _csr_from_pairs(keys, vals, nv)
    dofs, sizes = _pad_csr(starts, vals, -1)

    # vertex -> cells
    cells = mesh.cells
    ck = cells.ravel().astype(np.int64)
    cv = np.repeat(np.arange(mesh.num_cells, dtype=np.int64),
                   cells.shape[1])
    cstarts, cvals = _csr_from_pairs(ck, cv, nv)
    pcells, ccounts = _pad_csr(cstarts, cvals, -1)

    return (dofs[seed_vertices], sizes[seed_vertices],
            pcells[seed_vertices], ccounts[seed_vertices])


def _rowwise_member_index(sorted_rows, queries, dump):
    """For each row: position of query values inside that row's sorted
    list, or ``dump`` when absent.  sorted_rows (n, m) padded with a
    sentinel larger than any value; queries (n, ...)."""
    n, m = sorted_rows.shape
    q = queries.reshape(n, -1)
    stride = np.int64(sorted_rows.max()) + 2
    flat_rows = (sorted_rows + np.arange(n, dtype=np.int64)[:, None]
                 * stride).ravel()
    flat_q = q + np.arange(n, dtype=np.int64)[:, None] * stride
    pos = np.searchsorted(flat_rows, flat_q.ravel()).reshape(q.shape)
    local = pos - np.arange(n, dtype=np.int64)[:, None] * m
    valid = (local >= 0) & (local < m)
    safe = np.clip(pos, 0, n * m - 1)
    found = valid & (flat_rows[safe] == flat_q)
    return np.where(found, local, dump).reshape(queries.shape)


def star_patches(space, mask_flat, seed_vertices=None):
    """Vertex-star patches (PCPatch construct_type star, dim 0)."""
    sdofs, _, pcells, _ = star_patch_dofs(space, seed_vertices)
    ps = PatchSet(space, mask_flat, sdofs, pcells)
    seeds = (seed_vertices if seed_vertices is not None
             else np.arange(space.mesh.num_vertices))
    ps.seed_points = space.mesh.vertices[seeds]
    return ps


def macrostar_patches(space, mask_flat):
    """MacroStar patches on an Alfeld/bary mesh
    (/root/reference/alfi/relaxation.py:163-177): for each MACRO vertex v,
    star(v) enlarged by the stars of the centroid (non-macro) vertices of
    every coarse cell adjacent to v.  Needed so the smoother captures the
    divergence-free kernel of the Scott-Vogelius AL velocity block."""
    mesh = space.mesh
    d = mesh.dim
    macro = np.where(mesh.macro_vertices)[0]
    nvp = int(mesh.macro_vertices.sum())
    sdofs_all, _, pcells_all, _ = star_patch_dofs(space)
    adj = pcells_all[macro]  # bary cells adjacent to each macro vertex
    padj = np.where(adj >= 0, adj // (d + 1), -1)  # parent (macro) cells
    padj, _ = _merge_scalar_dofs(
        padj, None, np.full((padj.shape[0], 0), -1, dtype=np.int64))
    # centroid vertex of parent cell u has id nvp + u (alfeld layout)
    cent = np.where(padj >= 0, nvp + padj, 0)
    ext = sdofs_all[cent].reshape(len(macro), -1)
    ext = np.where(np.repeat(padj >= 0, sdofs_all.shape[1], axis=1),
                   ext, -1)
    sdofs, _ = _merge_scalar_dofs(sdofs_all[macro], None, ext)
    # patch cells: all d+1 bary children of every adjacent parent cell
    cells = np.where(padj[:, :, None] >= 0,
                     padj[:, :, None] * (d + 1) + np.arange(d + 1),
                     -1).reshape(len(macro), -1)
    ps = PatchSet(space, mask_flat, sdofs, cells)
    ps.seed_points = mesh.vertices[macro]
    return ps


def cell_patches(space, mask_flat, patch_cells):
    """Patches spanning explicit cell groups — the engine of the Schoeberl
    transfer (CoarseCellPatches / CoarseCellMacroPatches,
    /root/reference/alfi/transfer.py:13-88): patch p owns all dofs of
    cells ``patch_cells[p]`` except those masked out by ``mask_flat``."""
    patch_cells = np.asarray(patch_cells, dtype=np.int64)
    cd = space.cell_dofs.astype(np.int64)
    sdofs = cd[np.clip(patch_cells, 0, None)].reshape(
        patch_cells.shape[0], -1)
    sdofs = np.where((patch_cells >= 0).repeat(cd.shape[1], axis=1),
                     sdofs, -1)
    # dedup per row
    sdofs, _ = _merge_scalar_dofs(
        sdofs, None, np.full((sdofs.shape[0], 0), -1, dtype=np.int64))
    return PatchSet(space, mask_flat, sdofs, patch_cells)


class PatchSet:
    """Static patch topology for a VECTOR space, ready for device use.

    Attributes (numpy, converted lazily by the solver):
    dofs     (np, m)   flattened global vector-dof ids, pad = ndof_flat
    cells    (np, mc)  adjacent cells, pad = nc (dump tensor row)
    l2p      (np, mc, nld) cell-local flat dof -> patch-local, pad = m
    active   (np, m)   bool, True for real (non-pad) patch slots
    """

    def __init__(self, space, mask_flat, sdofs, pcells):
        d = space.value_size
        sdofs = np.asarray(sdofs, dtype=np.int64)
        pcells = np.asarray(pcells, dtype=np.int64)
        npat = sdofs.shape[0]
        # scalar -> vector dofs, drop constrained (mask==0) ones
        vd = np.where(sdofs[:, :, None] >= 0,
                      sdofs[:, :, None] * d + np.arange(d)[None, None, :],
                      -1).reshape(npat, -1)
        keep = (vd >= 0) & (mask_flat[np.clip(vd, 0, None)] > 0.5)
        vd = np.where(keep, vd, np.int64(np.iinfo(np.int64).max))
        vd.sort(axis=1)
        sizes_v = keep.sum(axis=1)
        m = int(sizes_v.max()) if npat else 0
        ndft = space.ndof * d
        # replace the huge sort sentinel with ndft so downstream int
        # arithmetic (stride offsets in _rowwise_member_index) can't
        # overflow; ndft is still larger than any real flat dof id
        vd = np.minimum(vd[:, :m], ndft)
        self.nflat = ndft
        self.m = m
        self.npatches = npat

        # cell-local flat dofs -> patch-local indices
        nc = space.mesh.num_cells
        nloc = space.cell_dofs.shape[1]
        cd = space.cell_dofs.astype(np.int64)
        cells_safe = np.clip(pcells, 0, nc - 1)
        local_flat = (cd[cells_safe][:, :, :, None] * d
                      + np.arange(d)[None, None, None, :]).reshape(
                          npat, pcells.shape[1], nloc * d)
        l2p = _rowwise_member_index(vd, local_flat, dump=m)
        # dead cell slots -> everything to dump row
        dead = pcells < 0
        l2p[dead] = m

        self.sizes = sizes_v
        self.active = np.arange(m)[None, :] < sizes_v[:, None]
        self.dofs = np.where(self.active, vd, ndft).astype(np.int64)
        self.cells = np.where(dead, nc, pcells).astype(np.int64)
        self.l2p = l2p.astype(index_dtype)
        #: vector size, for the d-row gather/scatter (_gather_scatter)
        self.space_d = d


def _merge_scalar_dofs(sdofs, sizes, extra):
    """Union per-row extra scalar dofs (np, k) into the padded lists;
    also dedups (``sizes`` is recomputed and may be None)."""
    merged = np.concatenate([sdofs, extra], axis=1)
    merged = np.where(merged >= 0, merged, np.int64(np.iinfo(np.int64).max))
    merged.sort(axis=1)
    # dedup per row
    dup = np.zeros_like(merged, dtype=bool)
    dup[:, 1:] = merged[:, 1:] == merged[:, :-1]
    merged = np.where(dup, np.int64(np.iinfo(np.int64).max), merged)
    merged.sort(axis=1)
    valid = merged < np.int64(np.iinfo(np.int64).max)
    sizes = valid.sum(axis=1)
    m = int(sizes.max())
    out = np.where(valid, merged, -1)[:, :m]
    return out, sizes


def direction_order(points, spec):
    """Lexicographic sweep order from a relaxation-direction spec like
    "0+:1-" (/root/reference/alfi/relaxation.py:88-108): sort by axis 0
    ascending, then axis 1 descending."""
    keys = []
    for part in spec.split(":"):
        axis = int(part[:-1])
        sgn = 1.0 if part[-1] == "+" else -1.0
        keys.append(sgn * points[:, axis])
    return np.lexsort(tuple(reversed(keys)))


def color_patchset(patchset, direction=None):
    """Conflict-free coloring of a PatchSet (shared-dof graph), visited
    in the sweep direction so colors respect the downstream ordering.
    Returns (colors (np,), ncolors)."""
    from ..native import greedy_color

    dofs = patchset.dofs
    active = patchset.active
    counts = active.sum(axis=1)
    csr_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    csr_vals = dofs[active].astype(np.int64)
    order = None
    if direction is not None and getattr(patchset, "seed_points",
                                         None) is not None:
        order = direction_order(patchset.seed_points, direction)
    return greedy_color(csr_off, csr_vals, patchset.nflat, order=order)


def build_multiplicative_solver(patchset, direction=None,
                                symmetrise=True):
    """Ordered multiplicative patch sweep as a sequence of conflict-free
    additive sub-sweeps (one per color) with residual updates in between
    — the batched formulation of PCPatch's multiplicative + symmetrise_sweep
    (/root/reference/alfi/solver.py:321-328).

    Returns (factor, apply) where apply(lufac, b_flat, Aop_flat) performs
    the full (symmetrised) sweep from a zero initial guess."""
    import jax
    import jax.numpy as jnp

    from ..solvers.batched_lu import get_factorization

    from ..utils.scatter import default_use_tables, make_gather_sum

    fs = get_factorization("patch")
    colors, ncolors = color_patchset(patchset, direction)
    factor, _ = build_patch_solver(patchset)
    # contiguous color blocks
    order = np.argsort(colors, kind="stable")
    bounds = np.searchsorted(colors[order], np.arange(ncolors + 1))
    dofs_c = [jnp.asarray(patchset.dofs[order[bounds[c]:bounds[c + 1]]])
              for c in range(ncolors)]
    act_c = [jnp.asarray(patchset.active[order[bounds[c]:bounds[c + 1]]])
             for c in range(ncolors)]
    sums_c = ([make_gather_sum(
        patchset.dofs[order[bounds[c]:bounds[c + 1]]], patchset.nflat)
        for c in range(ncolors)] if default_use_tables()
        else [None] * ncolors)
    order_j = np.asarray(order)

    # factor leaves are batch-major (np, ...) except for the
    # transposed-inverse layout, where the patch axis is minor
    ax = getattr(fs, "batch_axis", 0)

    def apply(lufac, b_flat, Aop):
        fac_o = jax.tree.map(
            lambda a: jnp.take(a, jnp.asarray(order_j), axis=ax), lufac)

        def color_solve(c, r_flat):
            rpad = jnp.concatenate(
                [r_flat, jnp.zeros((1,), dtype=r_flat.dtype)])
            rp = rpad[dofs_c[c]]
            sl = slice(int(bounds[c]), int(bounds[c + 1]))
            take = (lambda a: a[..., sl]) if ax == -1 else (
                lambda a: a[sl])
            xp = fs.solve(jax.tree.map(take, fac_o), rp)
            if sums_c[c] is not None:
                return sums_c[c](xp.astype(r_flat.dtype))
            xp = jnp.where(act_c[c], xp, 0.0)
            out = jnp.zeros((patchset.nflat + 1,), dtype=r_flat.dtype)
            return out.at[dofs_c[c]].add(xp)[:-1]

        x = jnp.zeros_like(b_flat)
        seq = list(range(ncolors))
        if symmetrise:
            seq = seq + seq[::-1]
        for i, c in enumerate(seq):
            r = b_flat if i == 0 else b_flat - Aop(x)
            x = x + color_solve(c, r)
        return x

    return factor, apply


def contract_patch_tensors(patchset, tensors):
    """(np, m, m) patch operators summed from per-cell element tensors
    (NO padding diagonal — see assemble_patch_matrices).

    A_p = sum_j P_j^T T_j P_j with P_j the 0/1 cell-local -> patch-local
    placement matrix, evaluated as a per-patch scatter-add of the
    member-cell tensors (runs once per Newton-step setup)."""
    import jax
    import jax.numpy as jnp

    from ..fem.nsforms import _map_cell_chunks

    m = patchset.m
    cells = jnp.asarray(patchset.cells)
    l2p = jnp.asarray(patchset.l2p.astype(np.int32))
    Tpad = jnp.concatenate(
        [tensors,
         jnp.zeros((1,) + tensors.shape[1:], dtype=tensors.dtype)],
        axis=0)
    mc = patchset.cells.shape[1]
    nld = tensors.shape[-1]

    def contract(cells_c, l2p_c):
        def one(cells_p, l2p_p):
            T = Tpad[cells_p]  # (mc, nld, nld)
            A = jnp.zeros((m + 1, m + 1), dtype=tensors.dtype)
            A = A.at[l2p_p[:, :, None], l2p_p[:, None, :]].add(T)
            return A[:m, :m]

        return jax.vmap(one)(cells_c, l2p_c)

    # chunk over patches: the vmapped member-cell gather materialises
    # (np, mc, nld, nld) — 8.3 GB at ldc3d nref=2; ~256 MB per
    # sequential chunk
    per_patch = mc * nld * nld * tensors.dtype.itemsize
    chunk = max(256, (256 << 20) // per_patch)
    return _map_cell_chunks(contract, cells, l2p, chunk=chunk)


def patch_facet_tables(patchset, facets, space):
    """Host tables mapping interior-facet Jacobians into patch
    operators: for each patch, the facets with >=1 adjacent cell in the
    patch (only those can share dofs with it) and the facet union-dof
    -> patch-local map.

    Returns (pfacets (np, mfp) [pad -> nif], fl2p (np, mfp, 2*nld)
    [pad/absent -> m])."""
    d = space.value_size
    cd = space.cell_dofs.astype(np.int64)
    nif = facets.nif
    fcells = np.asarray(facets.cells)  # (nif, 2) global cells
    nc = space.mesh.num_cells
    # cell -> interior facets (CSR)
    keys = fcells.reshape(-1)
    vals = np.repeat(np.arange(nif, dtype=np.int64), 2)
    starts, fv = _csr_from_pairs(keys, vals, nc)
    npat, mc = patchset.cells.shape
    # vectorised (patch, facet) pair enumeration — the per-patch
    # unique/concatenate loop took minutes of setup on fine levels
    cp = np.asarray(patchset.cells).astype(np.int64).ravel()
    valid = (cp >= 0) & (cp < nc)
    cpv = np.where(valid, cp, 0)
    cnt = np.where(valid, starts[cpv + 1] - starts[cpv], 0)
    total = int(cnt.sum())
    base = np.repeat(starts[cpv], cnt)
    csum = np.cumsum(cnt) - cnt
    offs = np.arange(total, dtype=np.int64) - np.repeat(csum, cnt)
    fids = fv[base + offs]
    pids = np.repeat(np.repeat(np.arange(npat, dtype=np.int64), mc),
                     cnt)
    key = np.unique(pids * np.int64(nif + 1) + fids)
    pstarts, pvals = _csr_from_pairs(key // (nif + 1), key % (nif + 1),
                                     npat)
    pfacets, _ = _pad_csr(pstarts, pvals, nif)
    if pfacets.shape[1] == 0:
        pfacets = np.full((npat, 1), nif, dtype=np.int64)
    # facet union flat dofs (nif+1, 2*nld); the pad value must MISS in
    # the patch dof rows — nflat itself is the patch-row pad and would
    # false-match, mapping facet pads onto inactive patch slots
    nld = cd.shape[1] * d
    fdofs = np.full((nif + 1, 2 * nld), patchset.nflat + 1,
                    dtype=np.int64)
    for s in range(2):
        flat = (cd[fcells[:, s]][:, :, None] * d
                + np.arange(d)[None, None, :]).reshape(nif, nld)
        fdofs[:nif, s * nld:(s + 1) * nld] = flat
    queries = fdofs[pfacets]  # (np, mfp, 2nld)
    fl2p = _rowwise_member_index(patchset.dofs, queries, dump=patchset.m)
    return pfacets, fl2p.astype(index_dtype)


def contract_patch_facet_tensors(pfacets, fl2p, Jf, m):
    """(np, m, m) patch contributions from interior-facet Jacobians
    Jf (nif, 2nld, 2nld) — the Burman coupling of the stabilised patch
    operators (scatter formulation; runs once per Newton-step setup)."""
    import jax
    import jax.numpy as jnp

    Jpad = jnp.concatenate(
        [Jf, jnp.zeros((1,) + Jf.shape[1:], dtype=Jf.dtype)], axis=0)
    pfacets = jnp.asarray(pfacets)
    fl2p = jnp.asarray(fl2p)

    def one(f_p, l2p_p):
        T = Jpad[f_p]  # (mfp, 2nld, 2nld)
        A = jnp.zeros((m + 1, m + 1), dtype=Jf.dtype)
        A = A.at[l2p_p[:, :, None], l2p_p[:, None, :]].add(T)
        return A[:m, :m]

    return jax.vmap(one)(pfacets, fl2p)


def patch_padding_identity(patchset, dtype):
    """(np, m, m) unit diagonal on padding slots so factorisations of
    padded patch matrices stay nonsingular."""
    import jax.numpy as jnp

    active = jnp.asarray(patchset.active)
    eye = jnp.eye(patchset.m, dtype=dtype)
    return jnp.where(active, 0.0, 1.0).astype(dtype)[:, :, None] * eye


def patch_padding_diag(patchset, dtype):
    """(np, m) diagonal of the padding identity — 1.0 on padding
    slots, 0.0 on active ones (the memory-lean form; embed with
    ``A.at[:, ar, ar].add(diag)``)."""
    import jax.numpy as jnp

    active = jnp.asarray(patchset.active)
    return jnp.where(active, 0.0, 1.0).astype(dtype)


def assemble_patch_matrices(patchset, tensors):
    """(np, m, m) patch operators summed from per-cell element tensors
    (unit diagonal on padding slots)."""
    return (contract_patch_tensors(patchset, tensors)
            + patch_padding_identity(patchset, tensors.dtype))


def patch_static_operators(patchset, form):
    """One-time (per level) patch contraction of the geometry-only
    Jacobian parts: {"K": viscous, "G": grad-div, "pad": identity} as
    (np, m, m) arrays.  The per-Newton-step patch matrix is then

        A_p(params, wind) = nu K_p + gamma G_p + advect N_p(wind) + pad

    with only the O(1)-scale advection part N contracted in the hot
    loop (see make_patch_factor_parts).  Call OUTSIDE jit and pass the
    result through the step function's arguments — closure-captured
    concrete arrays would be embedded as jit constants."""
    from ..config import real_dtype

    from ..config import mg_store

    K_el, G_el = form._static_velocity_tensors()
    # STORAGE dtype mg_store: at ldc3d nref=2 the fine
    # level's K+G are (4913, 189, 189) — 5.8 GB resident in f64 — and
    # the factorisation PROMOTES back to f64 (config.mg_store: a
    # consistent relative-eps32 perturbation of the operator, the
    # proven pattern).  The padding identity is stored as its DIAGONAL
    # (np, m) and embedded at factor time, not as a third dense array.
    sdt = mg_store()
    return {
        "K": contract_patch_tensors(patchset, K_el).astype(sdt),
        "G": contract_patch_tensors(patchset, G_el).astype(sdt),
        "pad_diag": patch_padding_diag(patchset, real_dtype),
    }


def make_patch_factor_parts(patchset):
    """factor_parts(static, N_el, params) -> batched factorisation of
    nu K_p + gamma G_p + advect N_p + pad."""
    import jax.numpy as jnp

    from ..solvers.batched_lu import get_factorization

    # the apply closure (build_patch_solver) picks the factor layout
    # (batch-major vs the structured patch-minor); reuse it
    fs = getattr(patchset, "_fs", None) or get_factorization("patch")

    def factor_parts(static, N_el, params):
        # f32-STORED static parts promote back through the f64 scalar
        # multiply (config.mg_store pattern); the padding identity is
        # embedded from its diagonal
        A = (params["nu"] * static["K"]
             + params["gamma"] * static["G"])
        ar = jnp.arange(A.shape[-1])
        A = A.at[:, ar, ar].add(static["pad_diag"].astype(A.dtype))
        if N_el is not None:
            Np = contract_patch_tensors(patchset, N_el)
            A = A + params["advect"] * Np.astype(A.dtype)
        return fs.factor(A)

    return factor_parts


def _scalar_pair_dofs(patchset, d):
    """(np, m//d) SCALAR dof table when every patch slot group of d
    consecutive entries holds the d components of one scalar dof (true
    whenever BCs constrain whole velocity vectors — the padded dof
    lists are sorted and comp-minor, so surviving components stay
    adjacent).  Returns None when the pairing fails (per-component
    constraints)."""
    dofs, active, m = patchset.dofs, patchset.active, patchset.m
    if d <= 1 or m % d:
        return None
    D = dofs.reshape(dofs.shape[0], m // d, d)
    act = active.reshape(dofs.shape[0], m // d, d)
    full = act.all(axis=2)
    none = ~act.any(axis=2)
    if not np.all(full | none):
        return None
    grouped = (D[:, :, :1] % d == 0) & (
        D == D[:, :, :1] + np.arange(d)[None, None, :])
    if not np.all(grouped[full]):
        return None
    nsc = patchset.nflat // d
    return np.where(full, D[:, :, 0] // d, nsc)


def _gather_scatter(patchset, transposed=False):
    """Patch gather/scatter closures; ``transposed=True`` works in the
    patch-minor (m, np) vector layout used by the transposed-inverse
    apply (solvers/batched_lu.apply_transposed_xla) — the gather produces it directly
    from the transposed dof table, so no on-device relayout happens.

    The batch-major path fetches d-VECTOR ROWS of the (ndof, d) view
    when the patch slots pair up, halving/thirding the number of random
    fetches."""
    import jax.numpy as jnp

    from ..utils.scatter import default_use_tables, make_gather_sum

    use_tables = default_use_tables()
    d = getattr(patchset, "space_d", None)
    sdofs_np = None
    if not transposed and use_tables and d:
        sdofs_np = _scalar_pair_dofs(patchset, d)
    if sdofs_np is not None:
        nsc = patchset.nflat // d
        sdofs = jnp.asarray(sdofs_np)
        ssum = make_gather_sum(sdofs_np, nsc)

        def gather(r_flat):
            r2 = r_flat.reshape(nsc, d)
            r2pad = jnp.concatenate(
                [r2, jnp.zeros((1, d), dtype=r_flat.dtype)])
            return r2pad[sdofs].reshape(-1, patchset.m)

        def scatter(xp, dtype):
            x3 = xp.astype(dtype).reshape(xp.shape[0], -1, d)
            return ssum(x3).reshape(-1)

        return gather, scatter

    dofs_np = patchset.dofs.T if transposed else patchset.dofs
    active_np = patchset.active.T if transposed else patchset.active
    dofs = jnp.asarray(dofs_np)
    active = jnp.asarray(active_np)
    # pad slots carry patchset.nflat and are dropped by the table
    gsum = (make_gather_sum(dofs_np, patchset.nflat)
            if use_tables else None)

    def gather(r_flat):
        rpad = jnp.concatenate(
            [r_flat, jnp.zeros((1,), dtype=r_flat.dtype)])
        return rpad[dofs]

    def scatter(xp, dtype):
        import jax.numpy as jnp

        if gsum is not None:
            # table never references padding slots; no masking needed
            return gsum(xp.astype(dtype))
        xp = jnp.where(active, xp, 0.0).astype(dtype)
        out = jnp.zeros((patchset.nflat + 1,), dtype=dtype)
        return out.at[dofs].add(xp)[:-1]

    return gather, scatter


def _structured_fs():
    """Factorisation for the sliced apply, which works on patch-minor
    (m, np) vectors: patch-minor explicit inverses, in the active
    explicit-inverse variant's dtype when there is one (an LU solve per
    apply on transposed vectors measured slower on the H100, PERF.md)."""
    from ..solvers.batched_lu import (
        _ExplicitInverseFactorization,
        get_factorization,
    )

    base = get_factorization("patch")
    if isinstance(base, _ExplicitInverseFactorization):
        if base.transposed:
            return base
        return _ExplicitInverseFactorization(
            base.apply_dtype, transposed=True, promote=base.promote)
    return _ExplicitInverseFactorization(None, transposed=True)


def build_patch_solver(patchset):
    """Device closures over a PatchSet:

    factor(tensors (nc, nld, nld)) -> batched factorisation of all patch
                                      matrices
    apply(fac, r_flat (ndft,))     -> additive-Schwarz application
    """
    from ..solvers.batched_lu import get_factorization
    from . import structured

    # sliced path: affine patch tables on structured meshes turn the
    # gather/scatter into dense slices (mg/structured.py)
    layout = (structured.detect(patchset)
              if structured.struct_patch_enabled() else None)
    if layout is not None:
        structured.reorder_patchset(patchset, layout.order)
        patchset.layout = layout
        gather, scatter = structured.gather_scatter(patchset, layout)
        fs = _structured_fs()
        patchset._fs = fs

        def factor(tensors):
            return fs.factor(assemble_patch_matrices(patchset, tensors))

        def apply(lufac, r_flat):
            xp = fs.solve_t(lufac, gather(r_flat))
            return scatter(xp, r_flat.dtype)

        return factor, apply

    fs = get_factorization("patch")
    patchset._fs = fs
    transposed = getattr(fs, "batch_axis", 0) == -1
    gather, scatter = _gather_scatter(patchset, transposed=transposed)
    fsolve = fs.solve_t if transposed else fs.solve

    def factor(tensors):
        return fs.factor(assemble_patch_matrices(patchset, tensors))

    def apply(lufac, r_flat):
        xp = fsolve(lufac, gather(r_flat))
        return scatter(xp, r_flat.dtype)

    return factor, apply


def woodbury_effective_gamma(gamma, S, safety=0.03, eps32=1.2e-7,
                             snorm=None):
    """Clamp gamma so the capacitance lambda_min = 1/gamma stays above
    the f32 round-off floor of |S| = |B^T M^-1 B| — adaptive (scale-
    aware), so well-scaled operators keep the exact gamma far beyond any
    fixed cap while badly-scaled ones degrade gracefully instead of
    producing a singular C.  ``snorm`` overrides the max|S| (the
    distributed path passes the pmax over the device mesh so every
    block clamps identically)."""
    import jax.numpy as jnp

    if snorm is None:
        snorm = jnp.max(jnp.abs(S))
    cap = safety / (eps32 * (snorm + 1e-30))
    return jnp.minimum(gamma.astype(S.dtype), cap.astype(S.dtype))


def build_patch_solver_woodbury(patchset, Bt_cells):
    """gamma-split patch solver, entirely in f32 (ALFI_TPU_WOODBURY=1).

    The AL patch operator A = M + gamma B B^T (M = viscous+advection,
    B = static grad-div factors) is singular to f32 round-off at the
    default gamma=1e4, so direct f32 factorisation fails (NaNs at
    Re>=100).  Woodbury moves gamma into a 1/gamma*I shift:

        A^-1 = M^-1 - (M^-1 B) (I/gamma + B^T M^-1 B)^-1 B^T M^-1

    where every factor is gamma-independently conditioned — native f32
    batched LU + matmuls, no f64 in the hot loop.

    factor(tensors_M (nc,nld,nld), gamma) -> (Mlu, Clu, Y, B)
    apply(fac, r_flat) -> additive application
    """
    import jax
    import jax.numpy as jnp

    dt = jnp.float32
    m = patchset.m
    np_, mc = patchset.cells.shape
    q = Bt_cells.shape[-1]
    r = mc * q
    cells = jnp.asarray(patchset.cells)
    l2p = jnp.asarray(patchset.l2p.astype(np.int32))
    gather, scatter = _gather_scatter(patchset)

    # one-time static patch factors Bp (np, m, r)
    Btpad = jnp.concatenate(
        [Bt_cells, jnp.zeros((1,) + Bt_cells.shape[1:],
                             dtype=Bt_cells.dtype)], axis=0)
    Bc = Btpad[cells]  # (np, mc, nld, q)

    def onep(l2p_p, Bc_p):
        # Bp[l2p_p[j, l], j, :] += Bc_p[j, l, :]
        Z = jnp.zeros((m + 1, mc, q), dtype=Bc_p.dtype)
        j_idx = jnp.broadcast_to(jnp.arange(mc)[:, None], l2p_p.shape)
        return Z.at[l2p_p, j_idx].add(Bc_p)

    Bp = jax.vmap(onep)(l2p, Bc)[:, :m].reshape(np_, m, r).astype(dt)

    def factor(tensors_M, gamma):
        Mp = assemble_patch_matrices(patchset, tensors_M).astype(dt)
        Mlu = jax.scipy.linalg.lu_factor(Mp)
        Y = jax.scipy.linalg.lu_solve(Mlu, Bp)  # (np, m, r)
        S = jnp.einsum("pmr,pms->prs", Bp, Y)
        geff = woodbury_effective_gamma(gamma, S)
        C = jnp.eye(r, dtype=dt) / geff + S
        Clu = jax.scipy.linalg.lu_factor(C)
        return {"Mlu": Mlu, "Clu": Clu, "Y": Y}

    def apply(fac, r_flat):
        rp = gather(r_flat).astype(dt)
        y = jax.scipy.linalg.lu_solve(fac["Mlu"], rp[..., None])[..., 0]
        t = jnp.einsum("pmr,pm->pr", Bp, y)
        s = jax.scipy.linalg.lu_solve(fac["Clu"], t[..., None])[..., 0]
        x = y - jnp.einsum("pmr,pr->pm", fac["Y"], s)
        return scatter(x, r_flat.dtype)

    return factor, apply
