"""Full-multigrid solver for the (nearly singular) AL velocity block.

JAX-native replacement for the reference's fieldsplit_0 "almg" branch
(/root/reference/alfi/solver.py:353-379): Richardson(1) wrapping a FULL
multigrid cycle whose level smoother is FGMRES(6 in 2D / 10 in 3D)
preconditioned by an additive star/macrostar patch smoother, and whose
coarse grid is a (telescoped) direct LU — here a dense LU on one device.

Everything per-Newton-step (coarse winds by injection, per-cell element
tensors, batched patch LUs, coarse dense LU) is (re)built inside jit from
(params, fine wind); the topology (patches, transfers, dof maps) is static
host data baked into the closures.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import mg_dtype, real_dtype
from ..fem import FunctionSpace, MixedFunctionSpace, NSForm, dg_lagrange
from ..fem.bcs import BCSet
from ..solvers.krylov import fgmres
from ..solvers.linear import assemble_dense_velocity, vector_rows
from .patches import build_patch_solver, macrostar_patches, star_patches
from .schoeberl import SchoeberlTransfer
from .transfer import injection, prolongation


class MGLevel:
    def __init__(self, V, form, mask_u, rows):
        self.V = V
        self.form = form
        self.mask_u = mask_u  # (ndof, d)
        self.mask_flat = mask_u.reshape(-1)
        self.rows = rows  # (nc, nloc*d) flattened dof rows
        from ..utils.scatter import default_use_tables, make_gather_sum

        #: scatter-add -> gather-sum tables (utils/scatter.py)
        self.row_sum = (make_gather_sum(np.asarray(rows),
                                        V.ndof * V.value_size)
                        if default_use_tables() else None)
        #: d-VECTOR-ROW index ops: rows are comp-minor (vector_rows),
        #: so gathering (nc, nloc) rows of the (ndof, d) view
        #: halves/thirds the fetch count of the flat gather
        self.srows = None
        self.srow_sum = None
        if self.row_sum is not None:
            self.srows = jnp.asarray(np.asarray(V.cell_dofs))
            self.srow_sum = make_gather_sum(np.asarray(V.cell_dofs),
                                            V.ndof)
        self.rows_t = None
        self.row_sum_t = None

    def gather_cells(self, v0):
        """(nc, nld) cell-local values from the flat vector ``v0``."""
        nld = self.rows.shape[1]
        if self.srows is None:
            return v0[self.rows]
        d = self.V.value_size
        return v0.reshape(self.V.ndof, d)[self.srows].reshape(-1, nld)

    def sum_cells(self, rloc, dtype):
        """Adjoint of gather_cells: accumulate (nc, nld) cell-local
        contributions into a flat (ndof*d,) vector."""
        if self.srow_sum is not None:
            d = self.V.value_size
            return self.srow_sum(
                rloc.reshape(rloc.shape[0], -1, d)).reshape(-1)
        if self.row_sum is not None:
            return self.row_sum(rloc)
        # accumulate in the contributions' dtype (f64 in the dc32
        # smoother) and cast the sum once; casting each contribution
        # to f32 instead moves the dc32 state 1.3e-10 from the
        # distributed solver's (tests/test_distributed.py), 2.9e-11 so
        out = jnp.zeros((self.V.ndof * self.V.value_size,),
                        dtype=rloc.dtype)
        return out.at[self.rows].add(rloc).astype(dtype)

    def ensure_transposed(self):
        """Cell-minor gather/sum companions for the transposed
        level_apply (ALFI_TPU_LEVEL_APPLY=t): vectors live as
        (nld, nc) so the element-tensor stream (i, j, c) has the large
        cell axis on lanes — see solvers/batched_lu.apply_transposed_xla for why the
        batch-major (c, i, j) layout wastes most of its HBM stream on
        XLA's minor-dim tile padding."""
        if self.rows_t is None:
            from ..utils.scatter import make_gather_sum

            rows_np = np.asarray(self.rows)
            self.rows_t = jnp.asarray(rows_np.T)
            self.row_sum_t = make_gather_sum(
                rows_np.T, self.V.ndof * self.V.value_size)


class VelocityMG:
    """Geometric MG hierarchy for the velocity block of one solver.

    Parameters
    ----------
    solver : NavierStokesSolver (supplies hierarchy, element, problem BCs,
        graddiv mode, smoothing count, patch kind)
    transfer_mode : 'standard' | 'schoeberl'
        'schoeberl' enables the robust prolongation (the reference's
        default via get_transfers, /root/reference/alfi/solver.py:588-597).
    """

    def __init__(self, solver, transfer_mode="schoeberl", smoother="patch",
                 smoother_driver="fgmres", cycle="full"):
        mh = solver.mh
        self.hierarchy = mh
        problem = solver.problem
        self.smoothing = solver.smoothing
        #: 'patch' or 'jacobi' (the graddiv study's weak baseline,
        #: /root/reference/examples/graddiv/graddiv.py:140-147)
        self.smoother = smoother
        #: 'fgmres' (NS solver) or 'chebyshev' (graddiv harness)
        self.smoother_driver = smoother_driver
        #: 'full' (FMG, the NS solver), 'w' or 'v' (graddiv harness)
        self.cycle = cycle
        #: use the Schoeberl ADJOINT for restriction too (--restriction
        #: flag; default False = standard restriction, matching
        #: /root/reference/alfi/solver.py:592-593)
        self.schoeberl_restriction = getattr(solver, "restriction", False)
        self.nlevels = len(mh)
        d = mh[0].dim
        self.d = d

        elem = solver.Z.V.element
        self.levels = []
        spaces = []
        for l, mesh in enumerate(mh):
            if l == self.nlevels - 1:
                V = solver.Z.V
                form = solver.form
                mask_u = solver.bcset.mask[0]
            else:
                from ..fem import VectorFunctionSpace

                V = VectorFunctionSpace(mesh, elem)
                Q = FunctionSpace(mesh, dg_lagrange(d, 0))
                Z = MixedFunctionSpace(V, Q)
                form = NSForm(V, Q, graddiv_mode=solver.form.graddiv_mode)
                mask_u = BCSet(Z, problem.bcs(Z)).mask[0]
            rows = jnp.asarray(np.asarray(vector_rows(V)))
            self.levels.append(MGLevel(V, form, mask_u, rows))
            spaces.append(V)

        import os

        #: MG-cycle dtype (config.mg_dtype): the per-iteration streaming
        #: work (level matvecs, smoother arithmetic, transfers, patch
        #: applies) runs here; factorisations stay f64
        self.cdt = mg_dtype()

        #: level-operator STORAGE dtype (config.mg_store): tensors can
        #: stream f32 bytes while the cycle computes in f64 — the
        #: widening converts fuse into the loads
        from ..config import mg_smooth_dtype, mg_store

        self.sdt = mg_store()

        #: smoother-internal COMPUTE dtype (config.mg_smooth_dtype):
        #: when narrower than cdt, _smooth switches to defect-
        #: correction form — f64 residual, f32 inner Krylov
        self.mdt = mg_smooth_dtype()

        #: cell-minor element-tensor layout for the level matvecs
        #: (see MGLevel.ensure_transposed)
        self.transposed_apply = (
            os.environ.get("ALFI_TPU_LEVEL_APPLY") == "t")
        if self.transposed_apply:
            for lev in self.levels:
                lev.ensure_transposed()

        # P1FB in 3D needs the bubble flux fix as its "standard" transfer
        # (/root/reference/alfi/transfer.py:334-356); everything else uses
        # plain nodal point evaluation.
        use_bubble = (d == 3 and elem.name == "P1FB"
                      and mh.kind != "bary")
        if use_bubble:
            from .bubble import BubbleTransfer as _BT

            self.prolongs = [_BT(mh, l) for l in range(self.nlevels - 1)]
        else:
            self.prolongs = [
                prolongation(mh, l, spaces[l], spaces[l + 1])
                for l in range(self.nlevels - 1)
            ]
        self.injects = [
            injection(mh, l, spaces[l + 1], spaces[l])
            for l in range(self.nlevels - 1)
        ]
        self.patch_composition = getattr(solver, "patch_composition",
                                         "additive")
        from ..config import use_woodbury

        #: gamma-split f32 factorisations; multiplicative sweeps
        #: currently keep the direct factorisation path
        self.use_woodbury = (use_woodbury()
                             and self.patch_composition == "additive")
        direction = problem.relaxation_direction()
        self.patch_solvers = []
        self.patchsets = []
        self.factor_parts = []
        for l in range(1, self.nlevels):
            lev = self.levels[l]
            if solver.patch == "macro":
                ps = macrostar_patches(lev.V, np.asarray(lev.mask_flat))
            else:
                ps = star_patches(lev.V, np.asarray(lev.mask_flat))
            self.patchsets.append(ps)
            if self.patch_composition == "multiplicative":
                from .patches import build_multiplicative_solver

                self.patch_solvers.append(
                    build_multiplicative_solver(ps, direction=direction))
                self.factor_parts.append(None)
            elif self.use_woodbury:
                from .patches import build_patch_solver_woodbury

                self.patch_solvers.append(build_patch_solver_woodbury(
                    ps, lev.form.graddiv_factors()))
                self.factor_parts.append(None)
            else:
                from .patches import make_patch_factor_parts

                self.patch_solvers.append(build_patch_solver(ps))
                self.factor_parts.append(make_patch_factor_parts(ps))

        if self.use_woodbury:
            # materialise the static grad-div factors OUTSIDE any jit
            # trace (the cache must hold concrete arrays, not tracers)
            for lev in self.levels:
                lev.form.graddiv_factors()

        self.schoeberl = None
        if transfer_mode == "schoeberl":
            self.schoeberl = [
                SchoeberlTransfer(self, l) for l in range(self.nlevels - 1)
            ]

        # coarse-solve strategy: dense on-device factorisation up to
        # the cap (an N^2 f64 factor plus its assembly; 13,000 flat dofs
        # is ~1.4 GB per copy), then the telescoped host sparse LU (the
        # SuperLU_dist analogue — solvers/host_coarse.py) so reference
        # bfs coarse meshes work as hierarchy bases
        lev0 = self.levels[0]
        N0d = lev0.V.ndof * d
        cap = int(os.environ.get("ALFI_TPU_DENSE_COARSE_MAX", "13000"))
        self._host_coarse = None
        if N0d > cap:
            from ..solvers.host_coarse import HostSparseCoarse

            self._host_coarse = HostSparseCoarse(
                np.asarray(lev0.rows), N0d, np.asarray(lev0.mask_flat))

        # ------------------------------------------------------------
        # stabilisation in the LEVEL OPERATORS: the reference assembles
        # its PCMG/PCPatch operators from the full stabilised Jacobian
        # (advect * stab added to the form, /root/reference/alfi/solver.py:204-237,
        # with the wind injected to every level,
        # /root/reference/alfi/stabilisation.py:29-43).  Without these
        # terms the preconditioner departs from the true Jacobian as Re
        # grows (measured: ldc2d+SUPG Krylov/Newton 10 -> 56 over Re
        # 100 -> 1500 before this wiring).
        # ------------------------------------------------------------
        self.stab = None
        st = getattr(solver, "stabilisation", None)
        if (st is not None and st.has_velocity_tensors
                and not self.use_woodbury
                and all(lev.form.Q.element.degree == 0
                        for lev in self.levels)):
            from ..stabilisation import make_stabilisation

            impls = [st] * self.nlevels
            for l in range(self.nlevels - 1):
                impls[l] = make_stabilisation(
                    self.levels[l].form, solver.stabilisation_type,
                    solver.supg_method, solver.supg_magic,
                    solver.stabilisation_weight,
                    char_LU=solver.char_L * solver.char_U)
            self.stab = impls
            # P0 pressure injection: coarse cell = mean of children
            self.c2f_cells = [
                jnp.asarray(np.asarray(mh.coarse_to_fine_cells(l)))
                for l in range(self.nlevels - 1)
            ]

        # ------------------------------------------------------------
        # Burman facet coupling in the LEVEL OPERATORS + PATCH MATRICES
        # (the reference assembles the full stabilised Jacobian incl.
        # the dS jump term into PCMG/PCPatch; ALFI_TPU_BURMAN_PC=0
        # disables for the ablation)
        # ------------------------------------------------------------
        self.stab_facet = None
        if (st is not None and st.has_facet_tensors
                and not self.use_woodbury and self.smoother == "patch"
                and os.environ.get("ALFI_TPU_BURMAN_PC", "1") == "1"):
            from ..stabilisation import BurmanStabilisation
            from ..utils.scatter import default_use_tables, \
                make_gather_sum
            from .patches import patch_facet_tables

            self.stab_facet = [
                (st.impl if l == self.nlevels - 1 else
                 BurmanStabilisation(self.levels[l].form,
                                     weight=st.impl.weight))
                for l in range(self.nlevels)
            ]
            self.facet_rows, self.facet_row_sums = [], []
            self.facet_rows_t, self.facet_row_sums_t = [], []
            for l in range(self.nlevels):
                fa = self.stab_facet[l].facets
                rows_np = np.asarray(self.levels[l].rows)
                fc = np.asarray(fa.cells)
                frows = np.concatenate(
                    [rows_np[fc[:, 0]], rows_np[fc[:, 1]]], axis=1)
                self.facet_rows.append(jnp.asarray(frows))
                self.facet_row_sums.append(
                    make_gather_sum(frows,
                                    self.levels[l].V.ndof * d)
                    if default_use_tables() else None)
                if self.transposed_apply:
                    self.facet_rows_t.append(jnp.asarray(frows.T))
                    self.facet_row_sums_t.append(make_gather_sum(
                        frows.T, self.levels[l].V.ndof * d))
                else:
                    self.facet_rows_t.append(None)
                    self.facet_row_sums_t.append(None)
            self.patch_facet_tabs = [
                patch_facet_tables(self.patchsets[l - 1],
                                   self.stab_facet[l].facets,
                                   self.levels[l].V)
                for l in range(1, self.nlevels)
            ]
            if self._host_coarse is not None:
                self._host_coarse.set_facets(
                    np.asarray(self.facet_rows[0]))
            # setup()'s facet branch factors patches directly from
            # assemble_patch_matrices + contract_patch_facet_tensors and
            # never reads static["levels"]; drop the static K/G patch
            # contractions so static_state() doesn't materialise unused
            # (np, m, m) arrays per level
            self.factor_parts = [None] * len(self.factor_parts)

    # ------------------------------------------------------------------
    # per-level masked operator from element tensors
    # ------------------------------------------------------------------
    def level_apply(self, l, tensors, v, ftensors=None):
        """A_l v on (ndof, d) arrays with eliminated BCs; ``ftensors``
        adds the interior-facet coupled (Burman) part.

        Tensor orientation is dispatched on shape: batch-major
        (nc, nld, nld) runs the einsum path; cell-minor (nld, nld, nc)
        — produced by setup under ALFI_TPU_LEVEL_APPLY=t — runs a
        multiply-reduce over cell-lane vectors, streaming the operator
        without XLA's minor-dim tile padding.

        A dict ``{"M", "B", "gamma"}`` is the GAMMA-SPLIT mixed-
        precision form used by the f32 cycle (config.mg_dtype): the
        gamma-free part M = nu K + advect N (+stabilisation) streams in
        the cycle dtype, while the AL term applies through its factors,
        gamma B (B^T v), with the q-dim dot ACCUMULATED IN F64.  An
        all-f32 contraction of the summed tensor nu K + gamma G rounds
        the gamma part at gamma*eps32 ~ 1e-3 ABSOLUTE, burying the
        viscous signal (~nu) on near-divergence-free fields — the
        measured round-2 blow-up of the f32 cycle at Re>=100.  The f64
        dot makes the per-apply rounding vanish where the term cancels;
        storing M and B in f32 is then only a CONSISTENT operator
        perturbation (relative eps32 of each part), which the outer
        flexible GMRES absorbs."""
        lev = self.levels[l]
        mask = lev.mask_u.astype(v.dtype)
        v0 = (mask * v).reshape(-1)
        nld = lev.rows.shape[1]
        if isinstance(tensors, dict):
            M, B = tensors["M"], tensors["B"]
            g64 = tensors["gamma"].astype(jnp.float64)
            if M.shape[-1] != nld:  # cell-minor gamma-split (t-layout)
                vloc_t = v0[lev.rows_t]  # (nld, nc)
                # dtype promotion (not a cast): f32-stored M with f64
                # vectors computes in f64 (config.mg_store), f32 cycle
                # vectors keep the all-f32 path
                rloc_t = jnp.sum(M * vloc_t[None, :, :], axis=1)
                v64_t = vloc_t.astype(jnp.float64)
                if B.shape[0] == 1:  # q=1, stored (1, nld, nc)
                    B1t = B[0].astype(jnp.float64)  # (nld, nc)
                    dq = jnp.sum(B1t * v64_t, axis=0)  # (nc,)
                    gpart_t = B1t * (g64 * dq)[None, :]
                else:  # (q, nld, nc)
                    B64t = B.astype(jnp.float64)
                    dq = jnp.einsum("pic,ic->pc", B64t, v64_t)
                    gpart_t = jnp.einsum("pic,pc->ic", B64t, g64 * dq)
                rloc_t = rloc_t + gpart_t.astype(rloc_t.dtype)
                rflat = lev.row_sum_t(rloc_t.astype(v.dtype))
            else:
                vloc = lev.gather_cells(v0)
                rloc = jnp.einsum("cij,cj->ci", M, vloc)
                if B.shape[-1] == 1:
                    # q=1 (pkp0 cell_avg): drop the unit q axis
                    B1 = B[:, :, 0].astype(jnp.float64)
                    d = jnp.sum(B1 * vloc.astype(jnp.float64), axis=1)
                    gpart = B1 * (g64 * d)[:, None]
                else:
                    B64 = B.astype(jnp.float64)
                    d = jnp.einsum("cip,ci->cp", B64,
                                   vloc.astype(jnp.float64))
                    gpart = jnp.einsum("cip,cp->ci", B64, g64 * d)
                rloc = rloc + gpart.astype(rloc.dtype)
                rflat = lev.sum_cells(rloc, v.dtype)
        elif tensors.shape[-1] != nld:  # cell-minor (nld, nld, nc)
            vloc = v0[lev.rows_t]  # (nld, nc)
            rloc = jnp.sum(tensors * vloc[None, :, :], axis=1)
            rflat = lev.row_sum_t(rloc.astype(v.dtype))
        else:
            vloc = lev.gather_cells(v0)
            rloc = jnp.einsum("cij,cj->ci", tensors, vloc)
            rflat = lev.sum_cells(rloc, v.dtype)
        if ftensors is not None:
            nfd = self.facet_rows[l].shape[1]
            if ftensors.shape[-1] != nfd:  # facet-minor (i, j, nif)
                vf = v0[self.facet_rows_t[l]]
                rf = jnp.sum(ftensors * vf[None, :, :], axis=1)
                rflat = rflat + self.facet_row_sums_t[l](
                    rf.astype(v.dtype))
            else:
                vf = v0[self.facet_rows[l]]
                rf = jnp.einsum("fij,fj->fi", ftensors, vf)
                if self.facet_row_sums[l] is not None:
                    rflat = rflat + self.facet_row_sums[l](rf)
                else:
                    dt = jnp.result_type(rflat, rf)
                    rflat = rflat.astype(dt).at[self.facet_rows[l]].add(
                        rf.astype(dt))
        r = rflat.reshape(lev.V.ndof, self.d).astype(v.dtype)
        return mask * r + (1.0 - mask) * v

    # ------------------------------------------------------------------
    def transfer_setup(self, params, statics=None):
        """Schoeberl transfer factorisations — depend only on (nu, gamma),
        so the solver computes them ONCE per Reynolds solve (the
        reference's parameter-keyed rebuild cache,
        /root/reference/alfi/transfer.py:168-184)."""
        if self.schoeberl is None:
            return None
        if statics is None:
            statics = [None] * len(self.schoeberl)
        return [t.setup(params, static=s)
                for t, s in zip(self.schoeberl, statics)]

    def static_state(self):
        """One-time static patch operators (smoother levels + Schoeberl
        transfers) as concrete arrays.  Compute OUTSIDE jit and pass the
        result to :meth:`setup` / :meth:`transfer_setup` through the step
        function's ARGUMENTS — capturing it in a jit closure would embed
        tens of MB of constants (observed to blow up XLA compile)."""
        from .patches import patch_static_operators

        levels = [
            (patch_static_operators(self.patchsets[l - 1],
                                    self.levels[l].form)
             if self.factor_parts[l - 1] is not None else None)
            for l in range(1, self.nlevels)
        ]
        schoeberl = ([t.static_ops() for t in self.schoeberl]
                     if self.schoeberl is not None else None)
        return {"levels": levels, "schoeberl": schoeberl}

    def setup(self, u_fine, params, schoeberl_state=None, static=None,
              p_fine=None):
        """Build the per-Newton-step state: winds, tensors, patch
        factorisations, coarse factorisation.  Pure (jit-safe; called
        inside the per-Newton-step trace)."""
        winds = [None] * self.nlevels
        winds[-1] = u_fine
        for l in range(self.nlevels - 2, -1, -1):
            winds[l] = self.injects[l].apply(winds[l + 1])
        gamma = params["gamma"]
        wb = self.use_woodbury
        stab_active = self.stab is not None and p_fine is not None
        if self.stab is not None and p_fine is None:
            import warnings

            warnings.warn(
                "VelocityMG.setup called without p_fine while "
                "stabilised level operators are wired: the cycle being "
                "built OMITS the stabilisation terms and is not the "
                "production preconditioner", stacklevel=2)
        if stab_active:
            press = [None] * self.nlevels
            press[-1] = p_fine
            for l in range(self.nlevels - 2, -1, -1):
                press[l] = jnp.mean(press[l + 1][self.c2f_cells[l]],
                                    axis=1)
            # frozen (z_last) wind injected per level, like the live one
            fwinds = [None] * self.nlevels
            fwinds[-1] = params["wind"]
            for l in range(self.nlevels - 2, -1, -1):
                fwinds[l] = self.injects[l].apply(fwinds[l + 1])
        # gamma-split mixed-precision streaming state for the f32
        # cycle: level_apply dict form (see its docstring).  Built
        # alongside the f64 tensors, which the setup-side consumers
        # (patch factorisation, coarse assembly, diagonals) still use.
        # Smoother-independent: _assemble_diag and the patch
        # factorisations consume the f64 lists, so EVERY smoother gets
        # the gamma-split stream — an all-f32 cast of nu*K + gamma*G is
        # exactly the gamma*eps32 blow-up level_apply documents.
        mixed_tensors = ([] if (self.cdt != real_dtype
                                or self.sdt != real_dtype) else None)
        N_els = None
        if wb:
            params_M = dict(params)
            params_M["gamma"] = jnp.zeros_like(gamma)
            tensors_M = [
                self.levels[l].form.velocity_element_tensors(
                    params_M, winds[l])
                for l in range(self.nlevels)
            ]
            # full operators for level_apply: M + gamma * Bt Bt^T
            tensors = [
                tM + gamma * jnp.einsum(
                    "cip,cjp->cij", self.levels[l].form.graddiv_factors(),
                    self.levels[l].form.graddiv_factors())
                for l, tM in enumerate(tensors_M)
            ]
            if mixed_tensors is not None:
                mixed_tensors = [
                    {"M": tM,
                     "B": self.levels[l].form.graddiv_factors(),
                     "gamma": gamma}
                    for l, tM in enumerate(tensors_M)
                ]
        else:
            # split form: only the advection part is wind-dependent; the
            # element tensors are reassembled cheaply and N is reused for
            # the patch matrices (and the level-0 gamma-free M tensors
            # for the Woodbury coarse solve)
            tensors, N_els = [], []
            for l in range(self.nlevels):
                form = self.levels[l].form
                K_el, G_el = form._static_velocity_tensors()
                N_el = form.advection_element_tensors(winds[l])
                if stab_active:
                    params_l = dict(params, wind=fwinds[l])
                    N_el = N_el + self.stab[l].velocity_tensors_hook(
                        (winds[l], press[l]), params_l)
                M_el = (params["nu"] * K_el
                        + params["advect"] * N_el)
                tensors.append(M_el + gamma * G_el)
                if mixed_tensors is not None:
                    mixed_tensors.append(
                        {"M": M_el, "B": form.graddiv_factors(),
                         "gamma": gamma})
                N_els.append(N_el)
        ftensors = [None] * self.nlevels
        if self.stab_facet is not None:
            # per-level Burman facet Jacobians at the injected winds
            # (advect-scaled like the cell stabilisation terms)
            ftensors = [
                params["advect"]
                * self.stab_facet[l].facet_velocity_tensors(winds[l],
                                                            params)
                for l in range(self.nlevels)
            ]
        if self.smoother == "patch":
            if self.stab_facet is not None:
                from ..solvers.batched_lu import get_factorization
                from .patches import (
                    assemble_patch_matrices,
                    contract_patch_facet_tensors,
                )

                patch_lufacs = []
                for l in range(1, self.nlevels):
                    ps = self.patchsets[l - 1]
                    # the patchset's BOUND factorisation (set by
                    # build_patch_solver): the struct sliced path
                    # stores patch-minor explicit inverses, and the
                    # apply closure expects that layout — factoring
                    # with the generic get_factorization here would
                    # hand it the wrong structure (native-LU tuples)
                    fs_p = (getattr(ps, "_fs", None)
                            or get_factorization("patch"))
                    Ap = assemble_patch_matrices(ps, tensors[l])
                    pf, fl2p = self.patch_facet_tabs[l - 1]
                    Ap = Ap + contract_patch_facet_tensors(
                        pf, fl2p, ftensors[l], ps.m)
                    patch_lufacs.append(fs_p.factor(Ap))
            elif wb:
                patch_lufacs = [
                    self.patch_solvers[l - 1][0](tensors_M[l], gamma)
                    for l in range(1, self.nlevels)
                ]
            elif static is not None:
                patch_lufacs = [
                    self.factor_parts[l - 1](static["levels"][l - 1],
                                             N_els[l], params)
                    if self.factor_parts[l - 1] is not None
                    else self.patch_solvers[l - 1][0](tensors[l])
                    for l in range(1, self.nlevels)
                ]
            else:
                patch_lufacs = [
                    self.patch_solvers[l - 1][0](tensors[l])
                    for l in range(1, self.nlevels)
                ]
        else:  # jacobi: operator diagonals per level
            patch_lufacs = [
                self._assemble_diag(l, tensors[l])
                for l in range(1, self.nlevels)
            ]
        from ..solvers.linear import (
            assemble_dense_from_tensors,
            assemble_dense_graddiv_factors,
            woodbury_dense_factor,
        )

        lev0 = self.levels[0]
        frows0 = (self.facet_rows[0] if self.stab_facet is not None
                  else None)
        if self._host_coarse is not None:
            # telescoped host sparse LU: factor per Newton step (cached
            # by fingerprint on the host), solves via pure_callback
            coarse_fac = {"host": tensors[0]}
            if ftensors[0] is not None:
                coarse_fac["hostf"] = ftensors[0]
        elif wb:
            M0 = assemble_dense_from_tensors(lev0.form, tensors_M[0],
                                             lev0.mask_u)
            B0 = assemble_dense_graddiv_factors(lev0.form, lev0.mask_u)
            coarse_fac = {"wb": woodbury_dense_factor(M0, B0, gamma)}
        else:
            from ..solvers.batched_lu import get_factorization

            A0 = assemble_dense_from_tensors(
                lev0.form, tensors[0], lev0.mask_u,
                facet_tensors=ftensors[0], facet_rows=frows0)
            coarse_fac = {"lu": get_factorization("coarse").factor(A0)}

        if self.transposed_apply:
            # pack the step-side operator stream cell-minor; skip any
            # level where the shape dispatch in level_apply would be
            # ambiguous (nc == nld, tiny test meshes only).  The
            # batch-major lists above were already consumed by the
            # setup-side assembly (patches, diagonals, coarse factor).
            tensors = [
                (jnp.moveaxis(T, 0, -1)
                 if T.shape[0] != T.shape[-1] else T)
                for T in tensors
            ]
            if mixed_tensors is not None:
                # gamma-split dicts go cell-minor too: M (nld,nld,nc),
                # B (q,nld,nc) — level_apply dispatches on M's shape
                mixed_tensors = [
                    ({"M": jnp.moveaxis(mt["M"], 0, -1),
                      "B": jnp.transpose(mt["B"], (2, 1, 0)),
                      "gamma": mt["gamma"]}
                     if mt["M"].shape[0] != mt["M"].shape[-1] else mt)
                    for mt in mixed_tensors
                ]
            ftensors = [
                (jnp.moveaxis(F, 0, -1)
                 if F is not None and F.shape[0] != F.shape[-1] else F)
                for F in ftensors
            ]
        state = {
            "tensors": (mixed_tensors if mixed_tensors is not None
                        else tensors),
            "ftensors": ftensors,
            "patch_lufacs": patch_lufacs,
            "coarse_fac": coarse_fac,
        }
        if self.schoeberl is not None:
            state["schoeberl"] = (schoeberl_state
                                  if schoeberl_state is not None
                                  else [t.setup(params)
                                        for t in self.schoeberl])
        if self.cdt != real_dtype:
            # factorisations were computed in f64 above (the gamma-
            # conditioned cancellation lives there); the STORED cycle
            # state is cast once here so every per-iteration op streams
            # cdt bytes.  The level operators are stored GAMMA-SPLIT
            # (mixed_tensors above) so the f32 stream keeps the AL
            # term's cancellation — see level_apply.  The coarse factor
            # keeps its own precision mix (f64 QR / f32 LU + f64
            # refinement / host) — _coarse_solve casts at its boundary.
            # ALFI_TPU_MG_F64_KEYS names state entries kept in f64
            # (comma-separated: schoeberl, patch_lufacs, tensors,
            # ftensors) — the precision-mix tuning knob.
            import os as _os

            from ..utils.tree import cast_floating

            keep = set(
                k for k in _os.environ.get(
                    "ALFI_TPU_MG_F64_KEYS", "").split(",") if k)
            keep.add("coarse_fac")
            state = {k: (v if k in keep
                         else cast_floating(v, self.cdt))
                     for k, v in state.items()}
        elif self.sdt != real_dtype:
            # store-f32 / compute-f64 (config.mg_store): ONLY the
            # gamma-split level-operator stream is narrowed; vectors,
            # smoother arithmetic, factorisations and transfers stay
            # f64, so the cycle is the f64 cycle applied to a
            # relative-eps32-perturbed operator — iteration parity by
            # consistency, half the matvec HBM bytes.  level_apply
            # computes via dtype promotion (f32 tensor x f64 vector ->
            # f64), so the converts fuse into the loads.
            from ..utils.tree import cast_floating

            state["tensors"] = cast_floating(state["tensors"], self.sdt)
            state["ftensors"] = cast_floating(state["ftensors"],
                                              self.sdt)
        if self.mdt != self.cdt and "patch_lufacs" in state:
            # defect-correction smoother (config.mg_smooth_dtype): the
            # patch factors are only ever applied INSIDE the inner mdt
            # Krylov loop (_smoother_pc), so store them in mdt — the
            # sweep streams half the bytes.  The FACTORISATION stays
            # f64 above: the gamma-conditioned cancellation lives in
            # computing the factor, not storing it.
            from ..utils.tree import cast_floating

            state["patch_lufacs"] = cast_floating(
                state["patch_lufacs"], self.mdt)
        if self.smoother_driver == "chebyshev":
            state["lmax"] = [
                self._estimate_lmax(l, state)
                for l in range(1, self.nlevels)
            ]
        return state

    def _assemble_diag(self, l, tensors):
        """Operator diagonal (flat) with 1.0 on constrained dofs."""
        lev = self.levels[l]
        dloc = jnp.einsum("cii->ci", tensors)
        if lev.row_sum is not None:
            diag = lev.row_sum(dloc)
        else:
            diag = jnp.zeros((lev.V.ndof * self.d,), dtype=dloc.dtype)
            diag = diag.at[lev.rows].add(dloc)
        mf = lev.mask_flat
        return mf * diag + (1.0 - mf)

    def _smoother_pc(self, l, state):
        lev = self.levels[l]
        if self.smoother == "patch":
            lufac = state["patch_lufacs"][l - 1]
            _, papply = self.patch_solvers[l - 1]
            if self.patch_composition == "multiplicative":
                tensors = state["tensors"][l]
                ften = state["ftensors"][l]

                def Aop_flat(xf):
                    return self.level_apply(
                        l, tensors, xf.reshape(-1, self.d),
                        ftensors=ften).reshape(-1)

                def pc(r):
                    mask = lev.mask_u.astype(r.dtype)
                    x = papply(lufac, (mask * r).reshape(-1),
                               Aop_flat).astype(r.dtype)
                    x = x.reshape(-1, self.d) * mask
                    return x + (1.0 - mask) * r

                return pc

            def pc(r):
                mask = lev.mask_u.astype(r.dtype)
                x = papply(lufac,
                           (mask * r).reshape(-1)).astype(r.dtype)
                x = x.reshape(-1, self.d) * mask
                return x + (1.0 - mask) * r

            return pc
        diag = state["patch_lufacs"][l - 1].reshape(-1, self.d)

        def pc(r):
            return r / diag

        return pc

    def _estimate_lmax(self, l, state, k=10):
        """Arnoldi-based estimate of the largest eigenvalue of the
        preconditioned operator — the PETSc gmres-esteig analogue: k
        Arnoldi steps, then sigma_max of the (k+1, k) Hessenberg.
        sigma_max(H) >= |Ritz|_max, an upper-flavoured estimate; plain
        power iteration converges to |lambda_max| FROM BELOW, and the
        resulting under-estimated Chebyshev interval cost one extra
        smoothing step vs the reference (round-1 weak finding)."""
        lev = self.levels[l]
        tensors = state["tensors"][l]
        ften = state["ftensors"][l]
        pc = self._smoother_pc(l, state)

        def op(x):
            return pc(self.level_apply(l, tensors, x, ftensors=ften))

        tdt = (tensors["M"].dtype if isinstance(tensors, dict)
               else tensors.dtype)
        v = lev.mask_u.astype(tdt) * jnp.ones(
            (lev.V.ndof, self.d), dtype=tdt)
        v = v / jnp.linalg.norm(v)
        Vs = [v]
        H = jnp.zeros((k + 1, k), dtype=real_dtype)
        for j in range(k):
            w = op(Vs[j])
            for i in range(j + 1):
                hij = jnp.sum(Vs[i] * w)
                H = H.at[i, j].set(hij)
                w = w - hij * Vs[i]
            hn = jnp.linalg.norm(w)
            H = H.at[j + 1, j].set(hn)
            Vs.append(w / (hn + 1e-300))
        # sigma_max(H) by power iteration on the k x k H^T H
        x = jnp.ones((k,), dtype=real_dtype)
        n = jnp.asarray(1.0, dtype=real_dtype)
        for _ in range(20):
            y = H.T @ (H @ x)
            n = jnp.linalg.norm(y)
            x = y / (n + 1e-300)
        return jnp.sqrt(n)

    # ------------------------------------------------------------------
    def coarse_apply(self, fac, bflat):
        """Apply the coarse factor (arrays-only state whose dict
        structure encodes the path: host sparse LU / direct dense LU /
        gamma-split f32)."""
        if "host" in fac:
            return self._host_coarse.solve(fac["host"], bflat,
                                           Jf=fac.get("hostf"))
        if "lu" in fac:
            from ..solvers.batched_lu import get_factorization

            return get_factorization("coarse").solve(fac["lu"], bflat)
        from ..solvers.linear import woodbury_dense_apply

        return woodbury_dense_apply(fac["wb"], bflat)

    def _coarse_solve(self, state, r):
        lev0 = self.levels[0]
        x = self.coarse_apply(
            state["coarse_fac"],
            r.reshape(-1).astype(real_dtype)).astype(r.dtype)
        mask = lev0.mask_u.astype(r.dtype)
        return (x.reshape(-1, self.d) * mask + (1.0 - mask) * r)

    def _smooth(self, l, state, b, x0):
        """Fixed-iteration level smoother: FGMRES(smoothing)+PC for the NS
        solver (ksp_convergence_test skip), or Chebyshev(smoothing)+PC for
        the graddiv harness (a LINEAR smoother, CG-compatible).
        ``x0=None`` means a zero initial guess (the defect/residual is
        then ``b`` itself — no operator application spent on it)."""
        tensors = state["tensors"][l]
        ften = state["ftensors"][l]
        pc = self._smoother_pc(l, state)

        def A(v):
            return self.level_apply(l, tensors, v, ftensors=ften)

        m = self.smoothing
        if self.smoother_driver == "chebyshev":
            from ..solvers.krylov import chebyshev

            if x0 is None:
                x0 = jnp.zeros_like(b)
            return chebyshev(A, b, pc, x0=x0, maxit=m,
                             lmax=state["lmax"][l - 1])
        if self.mdt != b.dtype:
            # defect-correction mixed precision (config.mg_smooth_dtype,
            # VERDICT r4 item 2): the defect b - A x0 is formed in the
            # cycle dtype (f64 residual accuracy bounds the cycle's
            # progress), then the fixed-iteration inner Krylov smooths
            # it from a ZERO guess in mdt — algebraically identical to
            # fgmres-from-x0 (x0 + Krylov(defect)), but the m matvecs,
            # patch applies and Arnoldi arithmetic run in f32.  The f32
            # rounding of the correction is relative to the defect, so
            # the contraction factor survives where the round-4 all-f32
            # cycle (f32 residual chain) lost iteration parity.
            r0 = b if x0 is None else b - A(x0)
            e, _ = fgmres(A, r0.astype(self.mdt), pc=pc, x0=None,
                          rtol=0.0, atol=-1.0, maxit=m, restart=m)
            e = e.astype(b.dtype)
            return e if x0 is None else x0 + e
        x, _ = fgmres(A, b, pc=pc, x0=x0, rtol=0.0, atol=-1.0,
                      maxit=m, restart=m)
        return x

    def _prolong(self, l, state, xc):
        """correction prolongation coarse level l -> l+1.  Output is
        cast back to the input (cycle) dtype so an f64-kept transfer
        state (ALFI_TPU_MG_F64_KEYS) doesn't leak f64 into an f32
        cycle."""
        if self.schoeberl is not None:
            xf = self.schoeberl[l].prolong(state["schoeberl"][l], xc)
        else:
            xf = self.prolongs[l].apply(xc)
        xf = xf.astype(xc.dtype)
        return self.levels[l + 1].mask_u.astype(xf.dtype) * xf

    def _restrict(self, l, state, rf):
        """residual restriction level l+1 -> l: the Schoeberl adjoint only
        behind --restriction, else the standard adjoint (reference
        default)."""
        if self.schoeberl is not None and self.schoeberl_restriction:
            rc = self.schoeberl[l].restrict(state["schoeberl"][l], rf)
        else:
            rc = self.prolongs[l].apply_transpose(rf)
        rc = rc.astype(rf.dtype)
        return self.levels[l].mask_u.astype(rc.dtype) * rc

    def vcycle(self, l, state, b, x0, ncoarse=1):
        """One V(1,1)-in-spirit cycle (ncoarse=2: W-cycle): the smoother
        block is used both pre and post, matching PETSc's default of
        reusing mg_levels as down/up smoother."""
        if l == 0:
            return self._coarse_solve(state, b)
        x = self._smooth(l, state, b, x0)
        for _ in range(ncoarse if l > 1 else 1):
            r = b - self.level_apply(l, state["tensors"][l], x,
                                     ftensors=state["ftensors"][l])
            rc = self._restrict(l - 1, state, r)
            xc = self.vcycle(l - 1, state, rc, None, ncoarse=ncoarse)
            x = x + self._prolong(l - 1, state, xc)
        return self._smooth(l, state, b, x)

    def fmg(self, state, b):
        """Full multigrid (pc_mg_type full): restrict the rhs to every
        level, coarse-solve, then per level prolong + one V-cycle."""
        bs = [None] * self.nlevels
        bs[-1] = b
        for l in range(self.nlevels - 2, -1, -1):
            bs[l] = self._restrict(l, state, bs[l + 1])
        x = self._coarse_solve(state, bs[0])
        for l in range(1, self.nlevels):
            x = self._prolong(l - 1, state, x)
            x = self.vcycle(l, state, bs[l], x)
        return x

    def make_solve_A(self, state):
        """rv -> MG-approximate A^{-1} rv (one Richardson iteration from
        zero = one cycle of the configured kind).  The cycle runs in
        ``self.cdt`` (config.mg_dtype) — the cast happens HERE, at the
        preconditioner boundary, so the outer Krylov stays f64."""
        L = self.nlevels - 1

        def solve_A(rv):
            rv_c = rv.astype(self.cdt)
            if self.cycle == "full":
                out = self.fmg(state, rv_c)
            else:
                ncoarse = 2 if self.cycle == "w" else 1
                out = self.vcycle(L, state, rv_c, None,
                                  ncoarse=ncoarse)
            return out.astype(rv.dtype)

        return solve_A
