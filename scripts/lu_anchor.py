"""Serial host-CPU Newton + sparse-LU anchor for the bench protocol.

VERDICT r3 weak #7 / next-round #9: three rounds of bench numbers were
anchored only to the round-1 build of this repo.  The reference solves
its 2D problems with PETSc direct LU (MUMPS/SuperLU, `lu`/`allu` modes,
/root/reference/alfi/solver.py:350,399) or almg on CPU clusters — so
the externally meaningful sanity anchor is: the SAME problem, SAME
residual, solved by the classical serial method (Newton + sparse direct
LU on one CPU core).  This script does exactly that:

* bench.py configuration: ldc2d [P2]^2-P0, baseN=16, nref=2 (41,474
  dofs), gamma=1e4, Re continuation 1 -> 10 -> 100;
* the Jacobian is assembled in CSR from graph-colored jvp probes of the
  repo's own masked residual (two dofs conflict iff they share a cell,
  so one jvp per color recovers all its columns exactly — no FD error);
* factored with scipy's SuperLU (the very library PETSc wraps), solved,
  plain Newton with the solver's own tolerances.

Prints one JSON line with the wall-clock decomposition; compare with
bench.py's almg number on the same problem.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("ALFI_TPU_FORCE_CPU", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as spla  # noqa: E402

from alfi_tpu import ConstantPressureSolver  # noqa: E402
from alfi_tpu.problems import TwoDimLidDrivenCavityProblem  # noqa: E402
from alfi_tpu.solvers.newton import newton  # noqa: E402

RES = [1, 10, 100]


def make_solver(dim):
    """The bench configuration for the chosen dimension: bench.py's
    ldc2d pkp0 nref=2 (41,474 dofs) or scripts/bench3d.py's ldc3d
    [P2+FB]^3-P0 baseN=4 nref=1 (37,395 dofs) — identical residual,
    tolerances and continuation, so the anchor is externally
    comparable to the almg number."""
    if dim == 3:
        from alfi_tpu.problems import ThreeDimLidDrivenCavityProblem

        return ConstantPressureSolver(
            ThreeDimLidDrivenCavityProblem(4), nref=1, k=2,
            solver_type="almg", hierarchy="uniform", gamma=1e4,
            verbose=False), "ldc3d p2fb baseN=4 nref=1 Re 1->100"
    return ConstantPressureSolver(
        TwoDimLidDrivenCavityProblem(16), nref=2, k=2,
        solver_type="almg", hierarchy="uniform", gamma=1e4,
        verbose=False), "ldc2d pkp0 baseN=16 nref=2 (41474 dofs) Re 1->100"


def build_coloring(solver):
    """Jacobian-pattern coloring for exact column recovery.

    J[i,j] != 0 iff dofs i,j share a cell (adjacency A).  Recovering
    column j from a probe of color c requires that NO other column of
    color c touches any row of column j — i.e. columns conflict iff
    they are within DISTANCE 2 in the cell-sharing graph (the classic
    A^T A / distance-2 coloring of CPR/finite-difference Jacobians).
    Greedy color of A@A's pattern; the entry pattern itself is A."""
    V, Q = solver.form.V, solver.form.Q
    d = solver.form.dim
    nu_flat = V.ndof * d
    ntot = nu_flat + Q.ndof
    cd_v = np.asarray(V.cell_dofs)  # (nc, nl)
    cd_q = np.asarray(Q.cell_dofs)  # (nc, nlq)
    nc = cd_v.shape[0]
    u_flat = (cd_v[:, :, None] * d
              + np.arange(d)[None, None, :]).reshape(nc, -1)
    cells = np.concatenate([u_flat, nu_flat + cd_q], axis=1)  # (nc, k)
    k = cells.shape[1]
    # (dof, cell) incidence -> adjacency A (pattern of J)
    B = sp.coo_matrix(
        (np.ones(nc * k, dtype=np.int8),
         (cells.reshape(-1), np.repeat(np.arange(nc), k))),
        shape=(ntot, nc)).tocsr()
    B.data[:] = 1
    A = (B @ B.T).tocsr()
    A.data[:] = 1
    A2 = (A @ A).tocsr()  # distance-2 conflict graph
    # greedy coloring over A2's rows
    color = np.full(ntot, -1, dtype=np.int64)
    indptr, indices = A2.indptr, A2.indices
    for j in range(ntot):
        nb = indices[indptr[j]:indptr[j + 1]]
        used = set(color[nb[color[nb] >= 0]].tolist())
        c = 0
        while c in used:
            c += 1
        color[j] = c
    ncolors = int(color.max()) + 1
    neighbours = [A.indices[A.indptr[j]:A.indptr[j + 1]]
                  for j in range(ntot)]
    return color, ncolors, neighbours, nu_flat, ntot


def main(dim=2):
    t_setup0 = time.perf_counter()
    solver, config = make_solver(dim)
    V, Q = solver.form.V, solver.form.Q
    d = solver.form.dim
    color, ncolors, neighbours, nu_flat, ntot = build_coloring(solver)

    # COO skeleton: for every column j, rows = neighbours[j]
    cols = np.concatenate([np.full(len(neighbours[j]), j)
                           for j in range(ntot)])
    rows = np.concatenate(neighbours)
    # value of entry (rows[i], cols[i]) comes from probe vector of
    # color[cols[i]] at position rows[i]
    probe_of_entry = color[cols]
    row_of_entry = rows

    def flat_res(zf, params):
        u = zf[:nu_flat].reshape(V.ndof, d)
        p = zf[nu_flat:]
        Ru, Rp = solver._residual_jit((u, p), params)
        return jnp.concatenate([Ru.reshape(-1), Rp])

    probes = np.zeros((ncolors, ntot))
    probes[color, np.arange(ntot)] = 1.0
    probes_j = jnp.asarray(probes)

    @jax.jit
    def jac_probes(zf, params):
        def one(e):
            return jax.jvp(lambda z: flat_res(z, params), (zf,), (e,))[1]
        return jax.vmap(one)(probes_j)  # (ncolors, ntot)

    # constrained rows: velocity Dirichlet mask + one pinned pressure
    # dof (constant-pressure nullspace, reference pins for LU,
    # /root/reference/alfi/solver.py:182-192)
    mask_u = np.asarray(solver.bcset.mask[0]).reshape(-1)
    bc_rows = np.where(mask_u == 0.0)[0]
    pin = nu_flat  # first pressure dof
    fixed = np.concatenate([bc_rows, [pin]])
    fixed_set = np.zeros(ntot, dtype=bool)
    fixed_set[fixed] = True
    keep = ~fixed_set[row_of_entry]  # drop entries in constrained rows

    def assemble(zf, params):
        J = np.asarray(jac_probes(zf, params))  # (ncolors, ntot)
        data = J[probe_of_entry, row_of_entry]
        A = sp.coo_matrix(
            (data[keep], (row_of_entry[keep], cols[keep])),
            shape=(ntot, ntot)).tocsr()
        ident = sp.coo_matrix(
            (np.ones(fixed.size), (fixed, fixed)), shape=(ntot, ntot))
        return (A + ident).tocsc()

    # self-check: three random recovered columns must equal direct
    # J e_j probes exactly (coloring correctness gate)
    zf0 = jnp.concatenate([solver.z[0].reshape(-1), solver.z[1]])
    params0 = solver.params()
    A0 = assemble(zf0, params0)
    rng = np.random.default_rng(0)
    for j in map(int, rng.integers(0, ntot, 3)):
        e = np.zeros(ntot)
        e[j] = 1.0
        col = np.array(jax.jvp(
            lambda z: flat_res(z, params0), (zf0,), (jnp.asarray(e),))[1])
        col[fixed] = 0.0
        col[j] += float(fixed_set[j])
        err = np.abs(np.asarray(A0[:, j].todense()).ravel() - col).max()
        assert err < 1e-10, (j, err)

    setup_s = time.perf_counter() - t_setup0
    tol = solver.tolerances
    timings = {"factor_s": 0.0, "jac_s": 0.0, "spsolve_s": 0.0}

    area = solver.area
    results = []
    t0 = time.perf_counter()
    for re in RES:
        if re == 0:
            solver.advect_val = 0.0
        else:
            solver.advect_val = 1.0
            solver.nu_val = solver.char_L * solver.char_U / re
        params = solver.params()
        solver.z_last = solver.z

        def residual(z):
            return solver._residual_jit(z, params)

        def linear(z, F):
            zf = np.concatenate([np.asarray(z[0]).reshape(-1),
                                 np.asarray(z[1])])
            tj = time.perf_counter()
            A = assemble(jnp.asarray(zf), params)
            timings["jac_s"] += time.perf_counter() - tj
            tf = time.perf_counter()
            lu = spla.splu(A)
            timings["factor_s"] += time.perf_counter() - tf
            rhs = -np.concatenate([np.asarray(F[0]).reshape(-1),
                                   np.asarray(F[1])])
            rhs[fixed] = 0.0
            ts = time.perf_counter()
            x = lu.solve(rhs)
            timings["spsolve_s"] += time.perf_counter() - ts
            du = jnp.asarray(x[:nu_flat].reshape(V.ndof, d))
            dp = jnp.asarray(x[nu_flat:])
            return (du, dp), 1

        z, info = newton(residual, linear, solver.z, maxit=20,
                         rtol=tol["snes_rtol"], atol=tol["snes_atol"],
                         stol=tol["snes_stol"])
        u, p = z
        pint = float(solver.form.pressure_integral(p))
        solver.z = (u, p - pint / area)
        results.append({"Re": re, "converged": bool(info.converged),
                        "newton": info.nonlinear_iter})
    elapsed = time.perf_counter() - t0
    print(json.dumps({
        "anchor": "newton_superlu_host_1core",
        "config": config,
        "elapsed_s": round(elapsed, 2),
        "setup_s": round(setup_s, 2),
        "ncolors": ncolors,
        **{k: round(v, 2) for k, v in timings.items()},
        "per_re": results,
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
