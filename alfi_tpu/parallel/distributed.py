"""The flagship almg Newton step, distributed with shard_map.

JAX-native re-design of the reference's MPI execution model (SURVEY.md
§2d/§5.8): DMPlex overlap partitions + VecScatter halo exchange +
allreduce dots become

* a block decomposition of the mesh hierarchy (parallel/decompose.py) —
  coarse partition, 2-layer overlap, partitions refined by lineage;
* ONE shard_map program per solver step in which every assembly, patch
  smoother sweep, Schoeberl transfer and Krylov iteration is block-local,
  with
    - interface-packed psums completing the owned-cells-only scatters
      (the VecScatter analogue, riding ICI),
    - owner-weighted psum inner products (the allreduce analogue,
      solvers/krylov.py::ShardDotContext),
    - the coarse grid assembled by a dense psum and solved replicated
      (the PCTelescope analogue, /root/reference/alfi/solver.py:354-377).

The computation mirrors the single-device almg step function-by-function
(same FGMRES, same FMG cycle, same patch solves), so results agree with
the global solver to summation-order roundoff — tests/test_distributed.py
checks this on the virtual 8-device CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import real_dtype
from ..solver import GREEN
from ..solvers.krylov import ShardDotContext, fgmres
from ..solvers.batched_lu import get_factorization
from .decompose import (
    LevelDecomp,
    _pad_rows_list,
    coarse_partition,
    expand_halo,
    propagate_blocks,
    split_patchset,
    split_transfer,
)

_I32 = jnp.int32


def _j(a, dtype=None):
    return jnp.asarray(np.asarray(a), dtype=dtype)


class _PatchSubset:
    """Row-sliced view of a PatchSet (one color of a multiplicative
    sweep) with the interface split_patchset needs."""

    def __init__(self, ps, sel):
        self.m = ps.m
        self.nflat = ps.nflat
        self.dofs = ps.dofs[sel]
        self.cells = ps.cells[sel]
        self.l2p = ps.l2p[sel]
        self.active = ps.active[sel]


class DistributedSolver:
    """shard_map-distributed execution of an existing almg solver.

    Parameters
    ----------
    solver : NavierStokesSolver with solver_type="almg" (its VelocityMG
        supplies the hierarchy, patch sets, Schoeberl transfers and
        tolerances; the decomposition localizes all of them).
    mesh : jax.sharding.Mesh (1D), one block per device.
    """

    def __init__(self, solver, mesh, axis="mesh", halo_layers=2,
                 partitioner=None):
        if solver.solver_type != "almg":
            raise ValueError("DistributedSolver requires solver_type=almg")
        if partitioner is None:
            partitioner = ("rcb" if getattr(solver, "rebalance_vertices",
                                            False) else "lex")
        self.partitioner = partitioner
        self.stab = None
        self.stab_facet = None
        if solver.stabilisation is not None:
            from ..stabilisation import BurmanStabilisation, ShakibSUPG

            impl = solver.stabilisation.impl
            if isinstance(impl, ShakibSUPG):
                if getattr(solver.vmg, "stab", None) is None:
                    raise NotImplementedError(
                        "distributed stabilisation requires the "
                        "stabilised level operators (VelocityMG.stab)")
                # per-level StabilisationWrappers, mirroring the
                # single-device PC assembly (mg/velocity.py setup)
                self.stab = solver.vmg.stab
            elif isinstance(impl, BurmanStabilisation):
                if getattr(solver.vmg, "stab_facet", None) is None:
                    raise NotImplementedError(
                        "distributed Burman requires the facet-coupled "
                        "PC (VelocityMG.stab_facet; do not disable "
                        "ALFI_TPU_BURMAN_PC)")
                # per-level BurmanStabilisation impls (facets live fully
                # inside the 2-layer halo, so everything stays
                # block-local; facet OWNERSHIP = block of the side-0
                # cell, completed by the interface psum)
                self.stab_facet = solver.vmg.stab_facet
            else:
                raise NotImplementedError(type(impl).__name__)
        #: gamma-split f32 patch/coarse solves (mirrors
        #: VelocityMG.use_woodbury; the pmax'd gamma clamp keeps every
        #: block's capacitance identical to the global one)
        self.use_woodbury = bool(getattr(solver.vmg, "use_woodbury",
                                         False))
        #: ordered multiplicative sweeps as per-color additive sub-sweeps
        #: with halo exchange between colors
        self.multiplicative = (getattr(solver, "patch_composition",
                                       "additive") == "multiplicative")
        self.solver = solver
        self.mesh = mesh
        self.axis = axis
        vmg = solver.vmg
        self.vmg = vmg
        nb = int(mesh.devices.size)
        self.nb = nb
        mh = solver.mh
        self.nlevels = vmg.nlevels
        self.d = vmg.d
        fs = get_factorization("patch")
        self.fs = fs
        self.fs_dense = get_factorization("coarse")

        # ---------------- partition + halos (host) ----------------
        base = (mh.uniform_meshes[0] if mh.kind == "bary" else mh[0])
        if self.partitioner == "rcb":
            from .decompose import rcb_partition

            block0 = rcb_partition(base, nb)
        else:
            block0 = coarse_partition(base, nb)
        blocks, ublocks = propagate_blocks(mh, block0)
        self.blocks = blocks
        self.ublocks = ublocks

        # level-0 local cells: owned + 2-layer overlap, then refine the
        # partitions (children of local cells) down the hierarchy
        local_sets = []
        m0 = mh[0]
        loc0 = []
        for b in range(nb):
            owned = blocks[0] == b
            loc0.append(expand_halo(m0, owned, halo_layers))
        local_sets.append(loc0)
        for l in range(self.nlevels - 1):
            c2f = mh.coarse_to_fine_cells(l)
            nxt = []
            for b in range(nb):
                m = np.zeros(mh[l + 1].num_cells, dtype=bool)
                m[np.unique(c2f[local_sets[l][b]])] = True
                nxt.append(m)
            local_sets.append(nxt)

        # ---------------- per-level decompositions ----------------
        self.levs = []
        for l in range(self.nlevels):
            owned_cells, halo_cells = [], []
            for b in range(nb):
                own = np.where((blocks[l] == b) & local_sets[l][b])[0]
                hal = np.where((blocks[l] != b) & local_sets[l][b])[0]
                assert np.all(local_sets[l][b][blocks[l] == b]), (
                    "owned cells must be inside the local set")
                owned_cells.append(own)
                halo_cells.append(hal)
            self.levs.append(LevelDecomp(
                vmg.levels[l].V, owned_cells, halo_cells, blocks[l]))

        self._build_local_arrays()
        self._build_step_functions()

    # ------------------------------------------------------------------
    # host: localize every static table
    # ------------------------------------------------------------------
    def _level_arrays(self, l):
        vmg, lev = self.vmg, self.levs[l]
        V = vmg.levels[l].V
        form = vmg.levels[l].form
        d = self.d
        g = form.geom
        cells = np.clip(lev.cells_pad, 0, None)
        live = ~lev.dead
        jinv = np.where(live[:, :, None, None],
                        np.asarray(g.jinv)[cells], 0.0)
        detj = np.where(live, np.asarray(g.detj)[cells], 0.0)
        vol = np.where(live, np.asarray(g.vol)[cells], 1.0)
        Bt = np.where(live[:, :, None, None],
                      np.asarray(form.graddiv_factors())[cells], 0.0)
        mask_g = np.asarray(vmg.levels[l].mask_u)  # (ndof, d)
        mask = np.zeros((lev.nb, lev.L + 1, d))
        for b in range(lev.nb):
            v = lev.valid[b]
            mask[b, : lev.L][v] = mask_g[lev.gdofs[b][v]]
        ownerw = np.concatenate(
            [lev.owner.astype(np.float64),
             np.zeros((lev.nb, 1))], axis=1)[..., None]
        rows = np.where(
            lev.dead[:, :, None], lev.L * d,
            (lev.lcd[:, :, :, None] * d
             + np.arange(d)[None, None, None, :]).reshape(
                 lev.nb, lev.mc, -1))
        self._rows_np[l] = rows
        out = dict(
            lcd=_j(lev.lcd, _I32), rows=_j(rows, _I32),
            owned=_j(lev.owned_cell), live=_j(live),
            jinv=_j(jinv, real_dtype), detj=_j(detj, real_dtype),
            vol=_j(vol, real_dtype), Bt=_j(Bt, real_dtype),
            mask=_j(mask, real_dtype), ownerw=_j(ownerw, real_dtype),
            lidx=_j(lev.lidx, _I32), sslot=_j(lev.sslot, _I32),
        )
        if self.stab is not None:
            # localized stabilisation statics (cell sizes, quad points)
            # for the stabilised level operators / patch matrices; the
            # physical basis hessians are contracted in-trace from the
            # shared reference tabulation + the localized jinv
            im = self.stab[l].impl

            def lloc(arr, fill=0.0):
                a = np.asarray(arr)[cells]
                m = live.reshape(live.shape + (1,) * (a.ndim - 2))
                return np.where(m, a, fill)

            out["h"] = _j(np.where(live, np.asarray(im.h)[cells], 1.0),
                          real_dtype)
            if im.form.rhs is not None:
                xq_g = np.asarray(im.form.geom.quad_points_physical(
                    im.form.tab_v.ref_pts))
                out["xq"] = _j(lloc(xq_g), real_dtype)
            else:
                out["xq"] = _j(np.zeros(
                    (lev.nb, lev.mc, im.form.tab_v.nq, d)), real_dtype)
        return out

    def _build_local_arrays(self):
        vmg = self.vmg
        nb, d = self.nb, self.d
        mh = self.solver.mh
        loc = {}
        self._rows_np = [None] * self.nlevels
        loc["lev"] = [self._level_arrays(l) for l in range(self.nlevels)]

        # Burman facet tables: per level, each block's locally-complete
        # facets (both cells live — guaranteed within the 2-layer halo
        # for every facet adjacent to owned cells or local patches),
        # owner masks, dof rows and localized static tabulations
        self._facet_luts = None
        if self.stab_facet is not None:
            loc["facet"] = []
            self._facet_luts = []
            self._facet_sel = []
            for l in range(self.nlevels):
                im = self.stab_facet[l]
                fa = im.facets
                st = {k: np.asarray(v)
                      for k, v in im.facet_statics().items()}
                fc = np.asarray(fa.cells)
                lev = self.levs[l]
                lcells = lev.localize_cells(fc)  # (nb, nif, 2)
                live_f = np.all(lcells < lev.mc, axis=2)
                lf = _pad_rows_list(
                    [np.where(live_f[b])[0] for b in range(nb)], -1)
                mfl = lf.shape[1]
                sel = np.clip(lf, 0, None)
                dead = lf < 0
                fowner = self.blocks[l][fc[:, 0]]
                owned_f = np.where(dead, False,
                                   fowner[sel]
                                   == np.arange(nb)[:, None])
                self._facet_sel.append(lf)
                s01 = np.full((nb, mfl, 2), lev.mc, dtype=np.int64)
                luts = []
                for b in range(nb):
                    ids = lf[b][lf[b] >= 0]
                    s01[b, : len(ids)] = lcells[b][ids]
                    lut = np.full(fa.nif + 1, mfl, dtype=np.int64)
                    lut[ids] = np.arange(len(ids))
                    luts.append(lut)
                self._facet_luts.append(luts)
                # cell-dof tables of the two sides (dead -> dump row L)
                lcd01 = np.where(
                    s01[:, :, :, None] < lev.mc,
                    np.take_along_axis(
                        lev.lcd,
                        np.clip(s01, 0, lev.mc - 1).reshape(nb, -1, 1),
                        axis=1).reshape(nb, mfl, 2, -1),
                    lev.L)
                rows_np = self._rows_np[l]
                frows = np.where(
                    s01[:, :, :, None] < lev.mc,
                    np.take_along_axis(
                        rows_np,
                        np.clip(s01, 0, lev.mc - 1).reshape(nb, -1, 1),
                        axis=1).reshape(nb, mfl, 2, -1),
                    lev.L * d).reshape(nb, mfl, -1)

                def floc(a, fill=0.0):
                    v = a[sel]
                    m = dead.reshape(dead.shape
                                     + (1,) * (v.ndim - 2))
                    return np.where(m, fill, v)

                loc["facet"].append(dict(
                    lcd0=_j(lcd01[:, :, 0], _I32),
                    lcd1=_j(lcd01[:, :, 1], _I32),
                    frows=_j(frows, _I32), owned=_j(owned_f),
                    t0=_j(floc(st["t0"]), real_dtype),
                    t1=_j(floc(st["t1"]), real_dtype),
                    g0=_j(floc(st["g0"]), real_dtype),
                    g1=_j(floc(st["g1"]), real_dtype),
                    n=_j(floc(st["n"]), real_dtype),
                    coefc=_j(np.where(dead, 0.0, st["coefc"][sel]),
                             real_dtype)))

        # smoother patches (levels 1..): seed-vertex block assignment;
        # one patch group per sweep color (additive = one group of all)
        loc["patch"] = []
        self._patch_meta = []
        direction = self.solver.problem.relaxation_direction()
        for l in range(1, self.nlevels):
            lev = self.levs[l]
            mesh_l = mh[l]
            if self.solver.patch == "macro":
                from ..mg.patches import macrostar_patches
                ps = macrostar_patches(
                    vmg.levels[l].V,
                    np.asarray(vmg.levels[l].mask_flat))
                seeds = np.where(mesh_l.macro_vertices)[0]
            else:
                from ..mg.patches import star_patches
                ps = star_patches(
                    vmg.levels[l].V,
                    np.asarray(vmg.levels[l].mask_flat))
                seeds = np.arange(mesh_l.num_vertices)
            # vertex owner block = block of smallest containing cell
            vowner = np.full(mesh_l.num_vertices,
                             np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(vowner, mesh_l.cells.ravel().astype(np.int64),
                          np.repeat(np.arange(mesh_l.num_cells,
                                              dtype=np.int64),
                                    mesh_l.cells.shape[1]))
            patch_block = self.blocks[l][vowner[seeds]]
            if self.multiplicative:
                from ..mg.patches import color_patchset

                colors, ncolors = color_patchset(ps, direction)
                groups = [np.where(colors == c)[0]
                          for c in range(ncolors)]
            else:
                groups = [np.arange(ps.npatches)]
            gdicts, gmeta = [], []
            for sel in groups:
                sp = split_patchset(_PatchSubset(ps, sel),
                                    patch_block[sel], lev)
                gmeta.append((sp["m"], sp["npm"]))
                gd = dict(
                    pdofs=_j(sp["pdofs"], _I32),
                    pcells=_j(sp["pcells"], _I32),
                    pl2p=_j(sp["pl2p"], _I32),
                    pactive=_j(sp["pactive"]))
                if self.stab_facet is not None:
                    # block-local slices of the patch facet tables
                    # (facets adjacent to a block's patches are local)
                    pfg, fl2pg = vmg.patch_facet_tabs[l - 1]
                    pfg, fl2pg = pfg[sel], fl2pg[sel]
                    nif_l = self.stab_facet[l].facets.nif
                    mfl = int(np.asarray(
                        loc["facet"][l]["owned"]).shape[1])
                    npm, mfp = sp["npm"], pfg.shape[1]
                    pfl = np.full((nb, npm, mfp), mfl, dtype=np.int64)
                    fl2p_b = np.full((nb, npm) + fl2pg.shape[1:],
                                     sp["m"], dtype=np.int64)
                    pb_sel = patch_block[sel]
                    for b in range(nb):
                        gsel_b = np.where(pb_sel == b)[0]
                        n = len(gsel_b)
                        if n == 0:
                            continue
                        ids = pfg[gsel_b]  # global facet ids, pad nif
                        lids = self._facet_luts[l][b][ids]
                        assert np.all(lids[ids < nif_l] < mfl), (
                            f"patch facets missing from block {b}")
                        pfl[b, :n] = lids
                        fl2p_b[b, :n] = fl2pg[gsel_b]
                    gd["pfl"] = _j(pfl, _I32)
                    gd["fl2p"] = _j(fl2p_b, _I32)
                gdicts.append(gd)
            self._patch_meta.append(gmeta)
            loc["patch"].append(gdicts)

        # Schoeberl transfer patches + skeleton masks per pair
        loc["sch"] = []
        for l in range(self.nlevels - 1):
            tr = vmg.schoeberl[l]
            levf = self.levs[l + 1]
            zmask_g = np.asarray(tr.zmask)
            zmask = np.zeros((nb, levf.L + 1, d))
            for b in range(nb):
                v = levf.valid[b]
                zmask[b, : levf.L][v] = zmask_g[levf.gdofs[b][v]]
            # patch p of the global set <-> coarse (uniform) cell p
            pblocks = (self.ublocks[l] if mh.kind == "bary"
                       else self.blocks[l])
            sp = split_patchset(tr.patchset, pblocks, levf)
            loc["sch"].append(dict(
                zmask=_j(zmask, real_dtype),
                pdofs=_j(sp["pdofs"], _I32), pcells=_j(sp["pcells"], _I32),
                pl2p=_j(sp["pl2p"], _I32), pactive=_j(sp["pactive"])))

        # nodal transfers per pair: prolongation (fine<-coarse) and
        # wind injection (coarse<-fine)
        loc["pro"], loc["inj"] = [], []
        for l in range(self.nlevels - 1):
            levc, levf = self.levs[l], self.levs[l + 1]
            need_f = levf.near_owned_dofs(mh[l + 1], layers=1)
            tr = vmg.prolongs[l]
            if hasattr(tr, "idx"):
                idx_g, w_g = (np.asarray(tr.idx, dtype=np.int64),
                              np.asarray(tr.w))
            else:
                # BubbleTransfer ([P1+FB]^3 flux fix): flatten the
                # composed map to a matrix-weighted gather table — the
                # component mixing rides W (ns, 3, 3) per source dof
                idx_g, w_g = tr.as_table()
            idx, w = split_transfer(idx_g, w_g, levc, levf, need_f)
            loc["pro"].append(dict(idx=_j(idx, _I32),
                                   w=_j(w, real_dtype)))
            need_c = levc.near_owned_dofs(mh[l], layers=1)
            trj = vmg.injects[l]
            idx, w = split_transfer(
                np.asarray(trj.idx, dtype=np.int64), np.asarray(trj.w),
                levf, levc, need_c)
            loc["inj"].append(dict(idx=_j(idx, _I32),
                                   w=_j(w, real_dtype)))

        # mixed fine-level extras: pressure per owned cell
        solver = self.solver
        form = solver.form
        Q = solver.Z.Q
        levf = self.levs[-1]
        nlq = Q.cell_dofs.shape[1]
        self.nlq = nlq
        mco = levf.mco
        owned0 = levf.cells_pad[:, :mco]
        live0 = owned0 >= 0
        qd = np.where(live0[:, :, None],
                      Q.cell_dofs.astype(np.int64)[
                          np.clip(owned0, 0, None)], -1)
        minv_g = np.asarray(form.pressure_mass_inverse())
        minv = np.where(live0[:, :, None, None],
                        minv_g[np.clip(owned0, 0, None)], 0.0)
        mask_p = np.asarray(solver.bcset.mask[1])
        pmask = np.where(live0[:, :, None],
                         mask_p[np.clip(qd, 0, None)], 0.0)
        if form.rhs is not None:
            xq_g = np.asarray(form.geom.quad_points_physical(
                form.tab_v.ref_pts))
            xq = np.where(live0[:, :, None, None],
                          xq_g[np.clip(owned0, 0, None)], 0.0)
        else:
            xq = np.zeros((nb, mco, form.tab_v.nq, d))
        validq = np.repeat(live0[:, :, None], nlq, axis=2)
        loc["mix"] = dict(
            qd=_j(qd, _I32), minv=_j(minv, real_dtype),
            pmask=_j(pmask, real_dtype), validq=_j(validq),
            xq=_j(xq, real_dtype))
        self._q_total = int(Q.ndof)

        if self.stab is not None:
            # ---- stabilised-PC plumbing ----
            # (a) fine-level CELL exchange: halo cells read the P0
            # pressure from their owner block (one packed psum; owner
            # slots are the first mco of cells_pad)
            ncells = mh[-1].num_cells
            cnt = np.zeros(ncells, dtype=np.int64)
            for b in range(nb):
                lc = levf.cells_pad[b][levf.cells_pad[b] >= 0]
                cnt[lc] += 1
            shared = np.where(cnt >= 2)[0]
            ncs = len(shared)
            slot = np.full(ncells, -1, dtype=np.int64)
            slot[shared] = np.arange(ncs)
            cl_l, cs_l = [], []
            for b in range(nb):
                cp = levf.cells_pad[b]
                sl = np.where(cp >= 0, slot[np.clip(cp, 0, None)], -1)
                ii = np.where(sl >= 0)[0]
                cl_l.append(ii)
                cs_l.append(sl[ii])
            pcl = _pad_rows_list(cl_l, levf.mc)
            pcs = _pad_rows_list(cs_l, ncs)
            pco = np.zeros(pcl.shape, dtype=bool)
            for b in range(nb):
                pco[b, : len(cl_l[b])] = cl_l[b] < levf.mco
            self._pstab_ncs = ncs
            loc["pstab"] = dict(cl=_j(pcl, _I32), cs=_j(pcs, _I32),
                                co=_j(pco))
            # (b) localized coarse->fine cell maps for the per-level P0
            # pressure restriction (children of any live local cell are
            # local by lineage construction)
            loc["c2f"] = []
            for l in range(self.nlevels - 1):
                c2f = np.asarray(mh.coarse_to_fine_cells(l))
                levc, levn = self.levs[l], self.levs[l + 1]
                rows_l = np.full((nb, levc.mc) + c2f.shape[1:],
                                 levn.mc, dtype=np.int64)
                for b in range(nb):
                    cp = levc.cells_pad[b]
                    livec = cp >= 0
                    gl = c2f[np.clip(cp, 0, None)]
                    c2l = np.full(mh[l + 1].num_cells, levn.mc,
                                  dtype=np.int64)
                    lv2 = levn.cells_pad[b] >= 0
                    c2l[levn.cells_pad[b][lv2]] = np.where(lv2)[0]
                    lr = c2l[gl]
                    assert np.all(lr[livec] < levn.mc), (
                        "children of live local cells must be local")
                    rows_l[b][livec] = lr[livec]
                loc["c2f"].append(_j(rows_l, _I32))

        # coarse dense solve tables
        lev0 = self.levs[0]
        V0 = vmg.levels[0].V
        N0d = V0.ndof * d
        self.N0d = N0d
        rows_g = (V0.cell_dofs.astype(np.int64)[:, :, None] * d
                  + np.arange(d)[None, None, :]).reshape(
                      V0.mesh.num_cells, -1)
        rows0 = np.where(lev0.dead[:, :, None], N0d,
                         rows_g[np.clip(lev0.cells_pad, 0, None)])
        gflat = np.where(
            lev0.valid[:, :, None],
            lev0.gdofs[:, :, None] * d + np.arange(d)[None, None, :],
            N0d)
        gflat = np.concatenate(
            [gflat, np.full((nb, 1, d), N0d, dtype=np.int64)], axis=1)
        loc["coarse"] = dict(rows=_j(rows0, _I32), gflat=_j(gflat, _I32))
        if self.stab_facet is not None:
            # global flat dof rows of the level-0 facets (for the
            # replicated coarse assembly; owner-masked before the psum)
            fc0 = np.asarray(self.stab_facet[0].facets.cells)
            fr_g = np.concatenate(
                [rows_g[fc0[:, 0]], rows_g[fc0[:, 1]]], axis=1)
            lf0 = self._facet_sel[0]
            crows = np.where((lf0 < 0)[:, :, None], N0d,
                             fr_g[np.clip(lf0, 0, None)])
            loc["coarse"]["frows"] = _j(crows, _I32)
        if self.use_woodbury:
            # dense grad-div factor columns (global cell id * q + j) for
            # the replicated gamma-split coarse solve
            q0 = int(np.asarray(
                vmg.levels[0].form.graddiv_factors()).shape[-1])
            R0 = V0.mesh.num_cells * q0
            self._coarse_R0 = R0
            cols = (lev0.cells_pad[:, :, None] * q0
                    + np.arange(q0)[None, None, :])
            cols = np.where(lev0.dead[:, :, None], R0, cols)
            loc["coarse"]["bcols"] = _j(cols, _I32)
        self._mask0_flat = _j(
            np.asarray(self.vmg.levels[0].mask_flat), real_dtype)

        self.loc = loc

    # ------------------------------------------------------------------
    # device: block-local building blocks (operate on [0]-sliced views)
    # ------------------------------------------------------------------
    def _exchange(self, lv, r):
        """Complete an owned-contributions scatter at interface dofs via
        one packed psum (the VecScatter analogue); keeps the dump row
        zero."""
        L = r.shape[0] - 1
        ns = int(lv["sslot_ns"])  # static, set by _annotate_ns
        buf = jnp.zeros((ns + 1, r.shape[1]), dtype=r.dtype)
        buf = buf.at[lv["sslot"]].add(r[lv["lidx"]])
        buf = lax.psum(buf, self.axis)
        r = r.at[lv["lidx"]].set(buf[lv["sslot"]])
        return r.at[L].set(0.0)

    def _exchange_cells(self, pst, pcell):
        """Fill halo-cell entries of a per-cell scalar array (mc+1, with
        a zero dump row) from the owner block via one packed psum (cells
        are uniquely owned: only owner slots contribute)."""
        ncs = self._pstab_ncs
        buf = jnp.zeros((ncs + 1,), dtype=pcell.dtype)
        contrib = jnp.where(pst["co"], pcell[pst["cl"]], 0.0)
        buf = buf.at[pst["cs"]].add(contrib)
        buf = lax.psum(buf, self.axis)
        pcell = pcell.at[pst["cl"]].set(buf[pst["cs"]])
        return pcell.at[-1].set(0.0)

    def _level_matvec(self, lv, T, v, fctx=None):
        """Masked velocity operator on (L+1, d) local arrays; ``fctx``
        = (facet tables, owner-masked facet Jacobians) adds the Burman
        coupling (owned-facet contributions completed by the psum)."""
        mask = lv["mask"]
        v0 = (mask * v).reshape(-1)
        vloc = v0[lv["rows"]]
        r = jnp.einsum("cij,cj->ci", T, vloc)
        r = jnp.where(lv["owned"][:, None], r, 0.0)
        L1 = v.shape[0]
        # the dc32 smoother hands f32 vectors to f64 tensors: cast the
        # contributions to the vector's dtype explicitly
        out = jnp.zeros((L1 * v.shape[1],), dtype=v.dtype)
        out = out.at[lv["rows"]].add(r.astype(v.dtype))
        if fctx is not None:
            fl, Jfo = fctx
            vf = v0[fl["frows"]]
            rf = jnp.einsum("fij,fj->fi", Jfo, vf)
            out = out.at[fl["frows"]].add(rf.astype(v.dtype))
        out = out.reshape(v.shape)
        out = self._exchange(lv, out)
        return mask * out + (1.0 - mask) * v

    def _facet_tensors(self, fl, im, u, params):
        """Block-local per-facet Burman Jacobians at the injected wind
        (advect-scaled); returns (raw, owner-masked) — raw feeds the
        patch matrices (each patch is assembled whole on its owner
        block), owner-masked feeds matvec/coarse scatters."""
        u01 = jnp.stack([u[fl["lcd0"]], u[fl["lcd1"]]], axis=1)
        st = {k: fl[k] for k in ("t0", "t1", "g0", "g1", "n", "coefc")}
        J = params["advect"] * im.facet_velocity_tensors_from(u01, st)
        return J, jnp.where(fl["owned"][:, None, None], J, 0.0)

    def _tensors(self, lv, form, w_u, params, stab=None):
        """Block-local velocity element tensors; with ``stab`` =
        (impl, press (mc+1,), fwind (L+1, d), aux) the stabilised
        Jacobian terms are added at advect scale, mirroring the
        single-device VelocityMG.setup stab wiring."""
        w_loc = w_u[lv["lcd"]]
        T = form.velocity_element_tensors_from(
            params, w_loc, lv["jinv"], lv["detj"], lv["Bt"])
        if stab is not None:
            im, press, fwind, aux = stab
            Ts = im.velocity_element_tensors_from(
                params, w_loc, press[:-1][:, None], fwind[lv["lcd"]],
                lv["jinv"], lv["detj"], lv["h"], lv["xq"], aux)
            T = T + params["advect"] * Ts
        return jnp.where(lv["live"][:, None, None], T, 0.0)

    def _patch_factor(self, pa, T, m, Jf=None):
        Tpad = jnp.concatenate(
            [T, jnp.zeros((1,) + T.shape[1:], dtype=T.dtype)], axis=0)
        if Jf is not None:
            Jpad = jnp.concatenate(
                [Jf, jnp.zeros((1,) + Jf.shape[1:], dtype=Jf.dtype)],
                axis=0)

            def one(cells_p, l2p_p, act_p, f_p, fl2p_p):
                Tt = Tpad[cells_p]
                A = jnp.zeros((m + 1, m + 1), dtype=T.dtype)
                A = A.at[l2p_p[:, :, None], l2p_p[:, None, :]].add(Tt)
                A = A.at[fl2p_p[:, :, None],
                         fl2p_p[:, None, :]].add(Jpad[f_p])
                A = A[:m, :m]
                return A + jnp.diag(
                    jnp.where(act_p, 0.0, 1.0).astype(A.dtype))

            return self.fs.factor(jax.vmap(one)(
                pa["pcells"], pa["pl2p"], pa["pactive"], pa["pfl"],
                pa["fl2p"]))

        def one(cells_p, l2p_p, act_p):
            Tt = Tpad[cells_p]
            A = jnp.zeros((m + 1, m + 1), dtype=T.dtype)
            A = A.at[l2p_p[:, :, None], l2p_p[:, None, :]].add(Tt)
            A = A[:m, :m]
            return A + jnp.diag(
                jnp.where(act_p, 0.0, 1.0).astype(A.dtype))

        return self.fs.factor(
            jax.vmap(one)(pa["pcells"], pa["pl2p"], pa["pactive"]))

    def _patch_apply(self, lv, pa, fac, r_flat, dtype):
        rp = r_flat[pa["pdofs"]]
        xp = self.fs.solve(fac, rp)
        xp = jnp.where(pa["pactive"], xp, 0.0).astype(dtype)
        out = jnp.zeros((r_flat.shape[0],), dtype=dtype)
        out = out.at[pa["pdofs"]].add(xp)
        d = self.d
        return self._exchange(lv, out.reshape(-1, d))

    def _patch_pc(self, lv, pa, fac):
        mask = lv["mask"]

        def pc(r):
            rf = (mask * r).reshape(-1)
            x = self._patch_apply(lv, pa, fac, rf, r.dtype)
            return mask * x + (1.0 - mask) * r

        return pc

    # ---------------- gamma-split (Woodbury) patch solves ----------------
    def _patch_factor_woodbury(self, lv, pa, T_M, m, gamma):
        """f32 gamma-split factorisation of the block's patches from the
        gamma-free tensors (mirrors mg/patches.py
        build_patch_solver_woodbury; the gamma clamp uses the pmax'd
        |S| so every block matches the global clamp)."""
        import jax.scipy.linalg as jsl

        from ..mg.patches import woodbury_effective_gamma

        dt = jnp.float32
        Tpad = jnp.concatenate(
            [T_M, jnp.zeros((1,) + T_M.shape[1:], dtype=T_M.dtype)],
            axis=0)
        Btpad = jnp.concatenate(
            [lv["Bt"], jnp.zeros((1,) + lv["Bt"].shape[1:],
                                 dtype=lv["Bt"].dtype)], axis=0)
        npm, mcp = pa["pcells"].shape
        q = lv["Bt"].shape[-1]

        def one(cells_p, l2p_p, act_p):
            Tt = Tpad[cells_p]
            A = jnp.zeros((m + 1, m + 1), dtype=T_M.dtype)
            A = A.at[l2p_p[:, :, None], l2p_p[:, None, :]].add(Tt)
            A = A[:m, :m] + jnp.diag(
                jnp.where(act_p, 0.0, 1.0).astype(T_M.dtype))
            Bc = Btpad[cells_p]  # (mcp, nld, q)
            Z = jnp.zeros((m + 1, mcp, q), dtype=Bc.dtype)
            j_idx = jnp.broadcast_to(jnp.arange(mcp)[:, None],
                                     l2p_p.shape)
            Bp = Z.at[l2p_p, j_idx].add(Bc)[:m].reshape(m, mcp * q)
            return A, Bp

        Mp, Bp = jax.vmap(one)(pa["pcells"], pa["pl2p"], pa["pactive"])
        Mp, Bp = Mp.astype(dt), Bp.astype(dt)
        Mlu = jsl.lu_factor(Mp)
        Y = jsl.lu_solve(Mlu, Bp)
        S = jnp.einsum("pmr,pms->prs", Bp, Y)
        snorm = lax.pmax(jnp.max(jnp.abs(S)), self.axis)
        geff = woodbury_effective_gamma(gamma, S, snorm=snorm)
        C = jnp.eye(mcp * q, dtype=dt) / geff + S
        Clu = jsl.lu_factor(C)
        return {"Mlu": Mlu, "Clu": Clu, "Y": Y, "Bp": Bp}

    def _patch_apply_woodbury(self, lv, pa, fac, r_flat, dtype):
        import jax.scipy.linalg as jsl

        rp = r_flat[pa["pdofs"]].astype(jnp.float32)
        y = jsl.lu_solve(fac["Mlu"], rp[..., None])[..., 0]
        t = jnp.einsum("pmr,pm->pr", fac["Bp"], y)
        s = jsl.lu_solve(fac["Clu"], t[..., None])[..., 0]
        xp = y - jnp.einsum("pmr,pr->pm", fac["Y"], s)
        xp = jnp.where(pa["pactive"], xp, 0.0).astype(dtype)
        out = jnp.zeros((r_flat.shape[0],), dtype=dtype)
        out = out.at[pa["pdofs"]].add(xp)
        return self._exchange(lv, out.reshape(-1, self.d))

    def _patch_pc_wb(self, lv, pa, fac):
        mask = lv["mask"]

        def pc(r):
            rf = (mask * r).reshape(-1)
            x = self._patch_apply_woodbury(lv, pa, fac, rf, r.dtype)
            return mask * x + (1.0 - mask) * r

        return pc

    # ---------------- multiplicative color sweeps ----------------
    def _patch_pc_mult(self, lv, pas, facs, T, fctx=None,
                       symmetrise=True):
        """Ordered multiplicative sweep: per-color additive sub-sweeps
        with block-local residual updates and halo exchange between
        colors (mirrors mg/patches.py build_multiplicative_solver)."""
        mask = lv["mask"]

        def pc(r):
            b = mask * r
            x = jnp.zeros_like(b)
            seq = list(range(len(pas)))
            if symmetrise:
                seq = seq + seq[::-1]
            for i, c in enumerate(seq):
                rr = (b if i == 0
                      else b - self._level_matvec(lv, T, x, fctx=fctx))
                x = x + self._patch_apply(lv, pas[c], facs[c],
                                          rr.reshape(-1), r.dtype)
            return mask * x + (1.0 - mask) * r

        return pc

    # ---------------- transfers ----------------
    def _prolong_std(self, pair, uc):
        vals = uc[pair["idx"]]  # (Lf, nlc, d)
        if pair["w"].ndim == 4:  # matrix weights (bubble flux fix)
            uf = jnp.einsum("lnab,lnb->la", pair["w"], vals)
        else:
            uf = jnp.einsum("ln,lnd->ld", pair["w"], vals)
        return jnp.concatenate(
            [uf, jnp.zeros((1, uf.shape[1]), dtype=uf.dtype)], axis=0)

    def _prolong_std_T(self, pair, lvc, ownerw_f, rf):
        rw = (rf * ownerw_f)[:-1]  # owned fine rows only
        if pair["w"].ndim == 4:  # exact adjoint of the matrix weights
            contrib = jnp.einsum("lnab,la->lnb", pair["w"], rw)
        else:
            contrib = pair["w"][:, :, None] * rw[:, None, :]
        Lc1 = lvc["mask"].shape[0]
        out = jnp.zeros((Lc1, rf.shape[1]), dtype=rf.dtype)
        out = out.at[pair["idx"]].add(contrib)
        return self._exchange(lvc, out)

    def _inject(self, pair, uf):
        vals = uf[pair["idx"]]  # (Lc, nlf, d)
        uc = jnp.einsum("ln,lnd->ld", pair["w"], vals)
        return jnp.concatenate(
            [uc, jnp.zeros((1, uc.shape[1]), dtype=uc.dtype)], axis=0)

    def _apply_gd(self, lv, gamma, v):
        """gamma-grad-div action from ALL live local cells, no exchange:
        exact at every dof whose containing cells are all local (in
        particular the interior dofs of this block's Schoeberl patches)."""
        vloc = v.reshape(-1)[lv["rows"]]
        t = jnp.einsum("clq,cl->cq", lv["Bt"], vloc)
        rloc = gamma * jnp.einsum("clq,cq->cl", lv["Bt"], t)
        out = jnp.zeros((v.shape[0] * v.shape[1],), dtype=v.dtype)
        out = out.at[lv["rows"]].add(rloc)
        return out.reshape(v.shape)

    def _sch_prolong(self, lvf, sch, fac, gamma, uc, pair):
        rhs = self._prolong_std(pair, uc)
        b = sch["zmask"] * self._apply_gd(lvf, gamma, rhs)
        tildeu = self._patch_apply(lvf, sch, fac, b.reshape(-1), b.dtype)
        return rhs - tildeu

    def _sch_restrict(self, lvf, lvc, sch, fac, gamma, rf, pair,
                      ownerw_f):
        t = self._patch_apply(lvf, sch, fac,
                              (sch["zmask"] * rf).reshape(-1), rf.dtype)
        b = self._apply_gd(lvf, gamma, t)
        return self._prolong_std_T(pair, lvc, ownerw_f, rf - b)

    # ------------------------------------------------------------------
    # device: the MG cycle (mirrors mg/velocity.py on local arrays)
    # ------------------------------------------------------------------
    def _mg_setup(self, loc, z, wloc, params):
        nl = self.nlevels
        u_fine, p_fine = z
        winds = [None] * nl
        winds[-1] = u_fine
        for l in range(nl - 2, -1, -1):
            winds[l] = self._inject(loc["inj"][l], winds[l + 1])
        stab_ctx = [None] * nl
        if self.stab is not None:
            # P0 pressure per LOCAL cell at every level: owner fill +
            # one cell exchange at the fine level, then local c2f means
            # down the hierarchy (children of live cells are local)
            lvf = loc["lev"][-1]
            mc_f = lvf["live"].shape[0]
            pcell = jnp.zeros((mc_f + 1,), dtype=u_fine.dtype)
            pcell = pcell.at[: p_fine.shape[0]].set(p_fine[:, 0])
            pcell = self._exchange_cells(loc["pstab"], pcell)
            press = [None] * nl
            press[-1] = pcell
            for l in range(nl - 2, -1, -1):
                pl = jnp.mean(press[l + 1][loc["c2f"][l]], axis=-1)
                press[l] = jnp.concatenate(
                    [pl, jnp.zeros((1,), dtype=pl.dtype)])
            # frozen (z_last) wind injected per level, like the live one
            fwinds = [None] * nl
            fwinds[-1] = wloc
            for l in range(nl - 2, -1, -1):
                fwinds[l] = self._inject(loc["inj"][l], fwinds[l + 1])
            for l in range(nl):
                im = self.stab[l].impl
                lv = loc["lev"][l]
                part = im.aux_partial(fwinds[l][lv["lcd"]], lv["detj"],
                                      lv["owned"])
                aux = (lax.psum(part, self.axis) / im._domain_measure
                       if part is not None else 0.0)
                stab_ctx[l] = (im, press[l], fwinds[l], aux)
        fJ, fJo = [None] * nl, [None] * nl
        if self.stab_facet is not None:
            for l in range(nl):
                fJ[l], fJo[l] = self._facet_tensors(
                    loc["facet"][l], self.stab_facet[l], winds[l],
                    params)
        gamma = params["gamma"]
        if self.use_woodbury:
            # gamma-split: factor from the gamma-free tensors, apply the
            # full operator (tensors already include gamma G via Bt)
            params_M = dict(params)
            params_M["gamma"] = jnp.zeros_like(gamma)
            tensors_M = [
                self._tensors(loc["lev"][l], self.vmg.levels[l].form,
                              winds[l], params_M, stab=stab_ctx[l])
                for l in range(nl)
            ]
            tensors = [
                tM + gamma * jnp.einsum(
                    "cip,cjp->cij", loc["lev"][l]["Bt"],
                    loc["lev"][l]["Bt"])
                for l, tM in enumerate(tensors_M)
            ]
            patch_facs = [
                [self._patch_factor_woodbury(
                    loc["lev"][l], pa, tensors_M[l], meta[0], gamma)
                 for pa, meta in zip(loc["patch"][l - 1],
                                     self._patch_meta[l - 1])]
                for l in range(1, nl)
            ]
        else:
            tensors = [
                self._tensors(loc["lev"][l], self.vmg.levels[l].form,
                              winds[l], params, stab=stab_ctx[l])
                for l in range(nl)
            ]
            patch_facs = [
                [self._patch_factor(pa, tensors[l], meta[0], Jf=fJ[l])
                 for pa, meta in zip(loc["patch"][l - 1],
                                     self._patch_meta[l - 1])]
                for l in range(1, nl)
            ]
        # replicated dense coarse factorisation (telescope analogue)
        lv0 = loc["lev"][0]
        N0d = self.N0d
        rows = loc["coarse"]["rows"]
        m0 = self._mask0_flat

        def dense0(T0loc):
            T0 = jnp.where(lv0["owned"][:, None, None], T0loc, 0.0)
            A = jnp.zeros((N0d + 1, N0d + 1), dtype=T0.dtype)
            A = A.at[rows[:, :, None], rows[:, None, :]].add(T0)
            if fJo[0] is not None:
                cfr = loc["coarse"]["frows"]
                A = A.at[cfr[:, :, None], cfr[:, None, :]].add(fJo[0])
            A = lax.psum(A[:N0d, :N0d], self.axis)
            return m0[:, None] * A * m0[None, :] + jnp.diag(1.0 - m0)

        if self.use_woodbury:
            from ..solvers.linear import woodbury_dense_closure

            M0 = dense0(tensors_M[0])
            # dense grad-div factor matrix, columns = global cell * q
            bc = loc["coarse"]["bcols"]
            Bt0 = jnp.where(lv0["owned"][:, None, None], lv0["Bt"], 0.0)
            R0 = self._coarse_R0
            B = jnp.zeros((N0d + 1, R0 + 1), dtype=Bt0.dtype)
            B = B.at[rows[:, :, None], bc[:, None, :]].add(Bt0)
            B = lax.psum(B[:N0d, :R0], self.axis)
            B = m0[:, None] * B
            coarse_state = woodbury_dense_closure(M0, B, gamma)
        else:
            coarse_state = self.fs_dense.factor(dense0(tensors[0]))
        mdt = getattr(self.vmg, "mdt", None)
        if mdt is not None and mdt != real_dtype:
            # defect-correction smoother (config.mg_smooth_dtype): the
            # patch factors live only inside the inner mdt Krylov loop
            # — store them in mdt, as the single-chip setup does
            # (mg/velocity.py)
            from ..utils.tree import cast_floating

            patch_facs = cast_floating(patch_facs, mdt)
        return dict(tensors=tensors, patch_facs=patch_facs,
                    coarse_fac=coarse_state, fJo=fJo)

    def _coarse_solve(self, loc, state, r):
        lv0 = loc["lev"][0]
        gflat = loc["coarse"]["gflat"]
        N0d = self.N0d
        rg = jnp.zeros((N0d + 1,), dtype=r.dtype)
        rg = rg.at[gflat].add(r * lv0["ownerw"])
        rg = lax.psum(rg[:N0d], self.axis)
        if self.use_woodbury:
            x = state["coarse_fac"](rg)
        else:
            x = self.fs_dense.solve(state["coarse_fac"], rg)
        xp = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        xl = xp[jnp.where(gflat < N0d, gflat, N0d)]
        mask = lv0["mask"]
        return mask * xl + (1.0 - mask) * r

    def _fctx(self, loc, state, l):
        if self.stab_facet is None:
            return None
        return (loc["facet"][l], state["fJo"][l])

    def _smooth(self, loc, state, l, b, x0):
        lv = loc["lev"][l]
        T = state["tensors"][l]
        pas = loc["patch"][l - 1]
        facs = state["patch_facs"][l - 1]
        fctx = self._fctx(loc, state, l)
        if self.multiplicative:
            pc = self._patch_pc_mult(lv, pas, facs, T, fctx=fctx)
        elif self.use_woodbury:
            pc = self._patch_pc_wb(lv, pas[0], facs[0])
        else:
            pc = self._patch_pc(lv, pas[0], facs[0])
        ctx = ShardDotContext(lv["ownerw"], self.axis)

        def A(v):
            return self._level_matvec(lv, T, v, fctx=fctx)

        m = self.solver.smoothing
        mdt = getattr(self.vmg, "mdt", b.dtype)
        if mdt != b.dtype:
            # defect-correction mixed precision, mirroring the
            # single-chip _smooth (mg/velocity.py): f64 defect, f32
            # inner Krylov (owner-weighted dots psum in f32)
            r0 = b if x0 is None else b - A(x0)
            e, _ = fgmres(A, r0.astype(mdt), pc=pc, x0=None, rtol=0.0,
                          atol=-1.0, maxit=m, restart=m, ctx=ctx)
            e = e.astype(b.dtype)
            return e if x0 is None else x0 + e
        x, _ = fgmres(A, b, pc=pc, x0=x0, rtol=0.0, atol=-1.0, maxit=m,
                      restart=m, ctx=ctx)
        return x

    def _prolong_mg(self, loc, tstate, l, xc):
        pair = loc["pro"][l]
        lvf = loc["lev"][l + 1]
        xf = self._sch_prolong(
            lvf, loc["sch"][l], tstate[l]["fac"], tstate[l]["gamma"],
            xc, pair)
        return lvf["mask"] * xf

    def _restrict_mg(self, loc, tstate, l, rf):
        pair = loc["pro"][l]
        lvc, lvf = loc["lev"][l], loc["lev"][l + 1]
        if self.vmg.schoeberl_restriction:
            rc = self._sch_restrict(
                lvf, lvc, loc["sch"][l], tstate[l]["fac"],
                tstate[l]["gamma"], rf, pair, lvf["ownerw"])
        else:
            rc = self._prolong_std_T(pair, lvc, lvf["ownerw"], rf)
        return lvc["mask"] * rc

    def _vcycle(self, loc, state, tstate, l, b, x0):
        if l == 0:
            return self._coarse_solve(loc, state, b)
        x = self._smooth(loc, state, l, b, x0)
        r = b - self._level_matvec(loc["lev"][l], state["tensors"][l],
                                   x, fctx=self._fctx(loc, state, l))
        rc = self._restrict_mg(loc, tstate, l - 1, r)
        xc = self._vcycle(loc, state, tstate, l - 1, rc, None)
        x = x + self._prolong_mg(loc, tstate, l - 1, xc)
        return self._smooth(loc, state, l, b, x)

    def _fmg(self, loc, state, tstate, b):
        nl = self.nlevels
        bs = [None] * nl
        bs[-1] = b
        for l in range(nl - 2, -1, -1):
            bs[l] = self._restrict_mg(loc, tstate, l, bs[l + 1])
        x = self._coarse_solve(loc, state, bs[0])
        for l in range(1, nl):
            x = self._prolong_mg(loc, tstate, l - 1, x)
            x = self._vcycle(loc, state, tstate, l, bs[l], x)
        return x

    # ------------------------------------------------------------------
    # device: mixed residual / Schur PC on local arrays
    # ------------------------------------------------------------------
    def _mixed_residual(self, loc, z, params, wloc):
        form = self.solver.form
        lv = loc["lev"][-1]
        mix = loc["mix"]
        u, p = z
        mco = mix["validq"].shape[0]
        lcd_o = lv["lcd"][:mco]
        u_cells = u[lcd_o]
        rv, rq = jax.vmap(
            lambda ul, pl, ji, dj, vo, x: form.cell_residual(
                ul, pl, ji, dj, vo, x, params)
        )(u_cells, p, lv["jinv"][:mco], lv["detj"][:mco],
          lv["vol"][:mco], mix["xq"])
        live = mix["validq"][:, :1]  # (mco, 1)
        if self.stab is not None:
            # owned-cells SUPG/GLS residual (the residual_hook analogue:
            # advect-scaled, live-state beta/Lu, frozen GLS wind)
            im = self.stab[-1].impl
            w_cells = wloc[lcd_o]
            part = im.aux_partial(w_cells, lv["detj"][:mco],
                                  lv["owned"][:mco])
            aux = (lax.psum(part, self.axis) / im._domain_measure
                   if part is not None else 0.0)
            rv_s, rq_s = im.residual_local(
                u_cells, p, w_cells, lv["jinv"][:mco],
                lv["detj"][:mco],
                lv["h"][:mco], mix["xq"], params, aux)
            advect = params["advect"]
            rv = rv + advect * rv_s
            if rq_s is not None:
                rq = rq + advect * rq_s
        rv = jnp.where(live[:, :, None], rv, 0.0)
        rq = jnp.where(mix["validq"], rq, 0.0)
        L1d = u.shape[0] * u.shape[1]
        Rv = jnp.zeros((L1d,), dtype=u.dtype)
        Rv = Rv.at[lv["rows"][:mco]].add(rv.reshape(mco, -1))
        if self.stab_facet is not None:
            # owned-facet Burman residual (live-state beta), completed
            # at interface dofs by the same packed psum as the cells
            im = self.stab_facet[-1]
            fl = loc["facet"][-1]
            st = {k: fl[k]
                  for k in ("t0", "t1", "g0", "g1", "n", "coefc")}
            r0, r1 = im.residual_pairs(u[fl["lcd0"]], u[fl["lcd1"]],
                                       st)
            rf = jnp.concatenate([r0, r1], axis=1)
            rf = rf.reshape(rf.shape[0], -1)
            rf = params["advect"] * jnp.where(fl["owned"][:, None], rf,
                                              0.0)
            Rv = Rv.at[fl["frows"]].add(rf)
        Rv = self._exchange(lv, Rv.reshape(u.shape))
        return (Rv, rq)

    def _residual_masked(self, loc, z, params, wloc):
        lv = loc["lev"][-1]
        Rv, Rq = self._mixed_residual(loc, z, params, wloc)
        return (lv["mask"] * Rv, loc["mix"]["pmask"] * Rq)

    def _apply_divergence(self, loc, t):
        form = self.solver.form
        tv, tq = form.tab_v, form.tab_q
        lv = loc["lev"][-1]
        mix = loc["mix"]
        mco = mix["validq"].shape[0]
        u_cells = t[lv["lcd"][:mco]]
        gu = jnp.einsum("qle,cej,cli->cqij", tv.gphi, lv["jinv"][:mco],
                        u_cells)
        divu = jnp.einsum("cqii->cq", gu)
        wdet = tv.w[None, :] * lv["detj"][:mco][:, None]
        rq = -jnp.einsum("cq,cq,ql->cl", wdet, divu, tq.phi)
        return jnp.where(mix["validq"], rq, 0.0)

    def _apply_pressure_gradient(self, loc, p):
        form = self.solver.form
        tv, tq = form.tab_v, form.tab_q
        lv = loc["lev"][-1]
        mix = loc["mix"]
        mco = mix["validq"].shape[0]
        p_q = jnp.einsum("ql,cl->cq", tq.phi, p)
        gtest = jnp.einsum("qle,cej->cqlj", tv.gphi, lv["jinv"][:mco])
        wdet = tv.w[None, :] * lv["detj"][:mco][:, None]
        rv = -jnp.einsum("cq,cq,cqld->cld", wdet, p_q, gtest)
        rv = jnp.where(mix["validq"][:, :1][:, :, None], rv, 0.0)
        u = jnp.zeros((lv["mask"].shape[0] * self.d,), dtype=p.dtype)
        u = u.at[lv["rows"][:mco]].add(rv.reshape(mco, -1))
        return self._exchange(lv, u.reshape(lv["mask"].shape))

    def _pressure_massinv(self, loc, s):
        return jnp.einsum("clm,cm->cl", loc["mix"]["minv"], s)

    def _pressure_mean_project(self, loc, z):
        """Remove the constant-pressure mode (Euclidean, matching the
        single-device projector)."""
        u, p = z
        mix = loc["mix"]
        tot = lax.psum(jnp.sum(jnp.where(mix["validq"], p, 0.0)),
                       self.axis)
        mean = tot / float(self._q_total)
        p = jnp.where(mix["validq"], p - mean, 0.0)
        return (u, p)

    # ------------------------------------------------------------------
    # step functions (jit + shard_map)
    # ------------------------------------------------------------------
    def _annotate_ns(self, loc_view):
        """Attach the static shared-buffer sizes to the level dicts (the
        device code reads them as Python ints)."""
        for l, lv in enumerate(loc_view["lev"]):
            lv["sslot_ns"] = self.levs[l].ns

    def _build_step_functions(self):
        axis = self.axis
        mesh = self.mesh
        solver = self.solver
        tol = solver.tolerances
        spec_b = P(axis)
        spec_r = P()
        has_nsp = solver.nsp
        d = self.d
        Lf = self.levs[-1].L

        def strip(tree):
            return jax.tree.map(lambda a: a[0], tree)

        # ----- transfer setup (per-Re Schoeberl factorisations) -----
        def tsetup_body(loc, params):
            loc = strip(loc)
            self._annotate_ns(loc)
            out = []
            for l in range(self.nlevels - 1):
                form = self.vmg.levels[l + 1].form
                lvf = loc["lev"][l + 1]
                params_a = dict(params)
                params_a["advect"] = jnp.zeros_like(params["advect"])
                zero_w = jnp.zeros_like(lvf["mask"])
                T = self._tensors(lvf, form, zero_w, params_a)
                m = self.vmg.schoeberl[l].patchset.m
                fac = self._patch_factor(loc["sch"][l], T, m)
                out.append(dict(fac=fac, gamma=params["gamma"]))
            return jax.tree.map(lambda a: a[None], out)

        def lin_body(loc, z, F, params, tstate, wloc):
            loc, z, F = strip(loc), strip(z), strip(F)
            tstate, wloc = strip(tstate), strip(wloc)
            self._annotate_ns(loc)
            lvf = loc["lev"][-1]
            mix = loc["mix"]

            state = self._mg_setup(loc, z, wloc, params)

            def solve_A(rv):
                return self._fmg(loc, state, tstate, rv)

            mask_u = lvf["mask"]
            minvscale = -(params["nu"] + params["gamma"])

            def pc(r):
                rv, rq = r
                t = solve_A(mask_u * rv)
                s = rq - self._apply_divergence(loc, t)
                p = minvscale * self._pressure_massinv(loc, s)
                w = mask_u * self._apply_pressure_gradient(loc, p)
                u = t - solve_A(w)
                return (u, p)

            # Jacobian action: jvp of the local residual (the psum
            # exchanges are linear, so this matches the global Jacobian)
            def res(zz):
                return self._mixed_residual(loc, zz, params, wloc)

            _, jvp = jax.linearize(res, z)
            pmask = mix["pmask"]

            def zero(v):
                return (mask_u * v[0], pmask * v[1])

            def identity_rows(r, v):
                return (mask_u * r[0] + (1.0 - mask_u) * v[0],
                        pmask * r[1] + (1.0 - pmask) * v[1])

            def J(v):
                Jv = jvp(zero(v))
                return identity_rows((mask_u * Jv[0], pmask * Jv[1]), v)

            project = (
                (lambda zz: self._pressure_mean_project(loc, zz))
                if has_nsp else None)
            weight = (lvf["ownerw"],
                      mix["validq"].astype(real_dtype))
            ctx = ShardDotContext(weight, axis)
            mF = (-F[0], -F[1])
            dz, info = fgmres(
                J, mF, pc=pc, rtol=tol["ksp_rtol"], atol=tol["ksp_atol"],
                maxit=500, restart=30, project=project, ctx=ctx)
            dz = zero(dz)
            return (jax.tree.map(lambda a: a[None], dz),
                    info["iters"][None])

        def res_body(loc, z, params, wloc):
            loc, z, wloc = strip(loc), strip(z), strip(wloc)
            self._annotate_ns(loc)
            F = self._residual_masked(loc, z, params, wloc)
            lvf = loc["lev"][-1]
            weight = (lvf["ownerw"],
                      loc["mix"]["validq"].astype(real_dtype))
            ctx = ShardDotContext(weight, self.axis)
            fnorm = ctx.norm(F)
            return jax.tree.map(lambda a: a[None], F), fnorm[None]

        def norms_body(loc, a, b):
            loc, a, b = strip(loc), strip(a), strip(b)
            self._annotate_ns(loc)
            lvf = loc["lev"][-1]
            weight = (lvf["ownerw"],
                      loc["mix"]["validq"].astype(real_dtype))
            ctx = ShardDotContext(weight, self.axis)
            return ctx.norm(a)[None], ctx.norm(b)[None]

        from jax import shard_map

        self._tsetup_sm = jax.jit(shard_map(
            tsetup_body, mesh=mesh, in_specs=(spec_b, spec_r),
            out_specs=spec_b, check_vma=False))
        self._lin_sm = jax.jit(shard_map(
            lin_body, mesh=mesh,
            in_specs=(spec_b, spec_b, spec_b, spec_r, spec_b, spec_b),
            out_specs=(spec_b, spec_b), check_vma=False))
        self._res_sm = jax.jit(shard_map(
            res_body, mesh=mesh,
            in_specs=(spec_b, spec_b, spec_r, spec_b),
            out_specs=(spec_b, spec_b), check_vma=False))
        self._norms_sm = jax.jit(shard_map(
            norms_body, mesh=mesh, in_specs=(spec_b, spec_b, spec_b),
            out_specs=(spec_b, spec_b), check_vma=False))

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------
    def transfer_setup(self, params):
        return self._tsetup_sm(self.loc, params)

    def load_balance(self, verbose=True):
        """Per-device ownership report — the reference's load_balance
        (/root/reference/alfi/solver.py:537-554: min/mean/max owned
        dofs over ranks with the max/min ratio).  Reports owned cells
        per level and fine-level velocity dofs (a dof is owned by the
        block of its owner cell)."""
        from ..mg.transfer import _dof_owner_cells

        stats = {}
        for l in range(self.nlevels):
            stats["cells_l%d" % l] = np.bincount(
                self.blocks[l], minlength=self.nb)
        V = self.vmg.levels[-1].V
        owner = _dof_owner_cells(V)
        stats["fine_vdofs"] = np.bincount(
            self.blocks[-1][owner], minlength=self.nb) * V.value_size
        if verbose:
            for name, c in stats.items():
                mn, mx, mean = int(c.min()), int(c.max()), float(c.mean())
                print("Load balance %-12s min %d  max %d  mean %.1f  "
                      "(ratio %.2f)" % (name, mn, mx, mean,
                                        mx / max(1, mn)))
        return stats

    def _zero_wind(self):
        if getattr(self, "_wind0", None) is None:
            levf = self.levs[-1]
            sh = NamedSharding(self.mesh, P(self.axis))
            self._wind0 = jax.device_put(
                jnp.zeros((self.nb, levf.L + 1, self.d),
                          dtype=real_dtype), sh)
        return self._wind0

    def _default_wind(self):
        """Frozen-wind default matching the global solver's convention
        (params['wind'] = z_last velocity): with stabilisation active a
        zero wind would silently change the discrete operator (or, for
        Turek SUPG, blow up beta), so derive it from solver.z_last."""
        if self.stab is not None:
            return self._shard_u(self.solver.z_last[0])
        return self._zero_wind()

    def residual(self, z, params, wind=None):
        """(F, fnorm) with F local-sharded and fnorm replicated."""
        if wind is None:
            wind = self._default_wind()
        F, fnorm = self._res_sm(self.loc, z, params, wind)
        return F, float(np.asarray(fnorm)[0])

    def linear_step(self, z, F, params, tstate, wind=None):
        if wind is None:
            wind = self._default_wind()
        dz, its = self._lin_sm(self.loc, z, F, params, tstate, wind)
        return dz, int(np.asarray(its)[0])

    def newton_step(self, z, params, tstate=None, wind=None):
        """One full Newton step (residual + almg-FGMRES solve + update)
        of the flagship solver, entirely distributed."""
        if tstate is None:
            tstate = self.transfer_setup(params)
        if wind is None:
            wind = self._default_wind()
        F, _ = self.residual(z, params, wind)
        dz, its = self.linear_step(z, F, params, tstate, wind)
        z = jax.tree.map(jnp.add, z, dz)
        return z, its

    # ---------------- drop-in solver surface ----------------
    # run_solver / the harnesses drive a DistributedSolver exactly like
    # a NavierStokesSolver (the reference gets this for free from
    # mpirun: same script, N ranks — /root/reference/examples/Makefile:1)
    @property
    def Z(self):
        return self.solver.Z

    @property
    def z(self):
        return self.solver.z

    @z.setter
    def z(self, val):
        self.solver.z = val

    def message(self, msg):
        self.solver.message(msg)

    def solve(self, re):
        """Reynolds-continuation solve on the distributed state, mirroring
        NavierStokesSolver.solve (host Newton loop, device steps)."""
        import time as _time

        solver = self.solver
        solver.z_last = solver.z
        solver.message(GREEN % ("Solving for Re = %s" % re))
        t_start = _time.perf_counter()
        if re == 0:
            solver.advect_val = 0.0
            solver.nu_val = solver.char_L * solver.char_U
        else:
            solver.advect_val = 1.0
            solver.nu_val = solver.char_L * solver.char_U / re
        params = solver.params()
        params.pop("wind", None)
        wind = (self._shard_u(solver.z_last[0])
                if self.stab is not None else self._zero_wind())
        z, _ = self.shard_state(solver.z, params)
        tstate = self.transfer_setup(params)
        tol = solver.tolerances
        F, fnorm = self.residual(z, params, wind)
        fnorm0 = fnorm
        total_lin = 0
        nit = 0
        converged, reason = fnorm <= tol["snes_atol"], "atol"
        while not converged and nit < 20:
            dz, its = self.linear_step(z, F, params, tstate, wind)
            total_lin += its
            z = jax.tree.map(jnp.add, z, dz)
            nit += 1
            F, fnorm = self.residual(z, params, wind)
            if not np.isfinite(fnorm):
                converged, reason = False, "diverged_fnorm_nan"
                break
            if fnorm <= tol["snes_atol"]:
                converged, reason = True, "atol"
                break
            if fnorm <= tol["snes_rtol"] * fnorm0:
                converged, reason = True, "rtol"
                break
            sn, zn = self._norms_sm(self.loc, dz, z)
            if float(np.asarray(sn)[0]) <= tol["snes_stol"] * float(
                    np.asarray(zn)[0]):
                converged, reason = True, "stol"
                break
        else:
            if not converged:
                reason = "max_it"
        solver.z = self.gather_state(z)
        elapsed = _time.perf_counter() - t_start
        solver.message(GREEN % (
            "Nonlinear solve %s in %d iterations (%s)" % (
                "converged" if converged else "DIVERGED", nit, reason)))
        solver.message(GREEN % (
            "Time taken: %.2f min in %d iterations "
            "(%.2f Krylov iters per Newton step)"
            % (elapsed / 60.0, total_lin, total_lin / max(1, nit))))
        info = {
            "Re": re, "nu": solver.nu_val, "linear_iter": total_lin,
            "nonlinear_iter": nit, "converged": bool(converged),
            "reason": reason, "time": elapsed / 60.0,
        }
        return solver.z, info

    # ---------------- state movement ----------------
    def _shard_u(self, u):
        """Global (ndofV, d) velocity -> block-local (nb, L+1, d)
        sharded array."""
        levf = self.levs[-1]
        u = np.asarray(u)
        nb, L = self.nb, levf.L
        ub = np.zeros((nb, L + 1, self.d))
        for b in range(nb):
            v = levf.valid[b]
            ub[b, :L][v] = u[levf.gdofs[b][v]]
        sh = NamedSharding(self.mesh, P(self.axis))
        return jax.device_put(jnp.asarray(ub, dtype=real_dtype), sh)

    def shard_state(self, z, params=None):
        """Global (u, p) -> block-local sharded arrays."""
        levf = self.levs[-1]
        u, p = np.asarray(z[0]), np.asarray(z[1])
        nb, L, d = self.nb, levf.L, self.d
        ub = np.zeros((nb, L + 1, d))
        for b in range(nb):
            v = levf.valid[b]
            ub[b, :L][v] = u[levf.gdofs[b][v]]
        mco = levf.mco
        qd = np.asarray(self.loc["mix"]["qd"])
        live = qd >= 0
        pb = np.where(live, p[np.clip(qd, 0, None)], 0.0)
        sh = NamedSharding(self.mesh, P(self.axis))
        zs = (jax.device_put(jnp.asarray(ub, dtype=real_dtype), sh),
              jax.device_put(jnp.asarray(pb, dtype=real_dtype), sh))
        if params is None:
            return zs
        rep = NamedSharding(self.mesh, P())
        pr = {k: jax.device_put(jnp.asarray(v), rep)
              for k, v in params.items()}
        return zs, pr

    def gather_state(self, z):
        """Block-local sharded arrays -> global (u, p)."""
        levf = self.levs[-1]
        ub = np.asarray(z[0])
        pb = np.asarray(z[1])
        V = self.solver.Z.V
        Q = self.solver.Z.Q
        u = np.zeros((V.ndof, self.d))
        for b in range(self.nb):
            own = levf.owner[b]
            u[levf.gdofs[b][own]] = ub[b, : levf.L][own]
        p = np.zeros((Q.ndof,))
        qd = np.asarray(self.loc["mix"]["qd"])
        live = qd >= 0
        for b in range(self.nb):
            p[qd[b][live[b]]] = pb[b][live[b]]
        return (jnp.asarray(u, dtype=real_dtype),
                jnp.asarray(p, dtype=real_dtype))
