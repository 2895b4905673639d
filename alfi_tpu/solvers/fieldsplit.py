"""Block-Schur preconditioner for the AL Navier-Stokes Jacobian.

Explicit JAX-native block algebra replacing PETSc PCFieldSplit with
``pc_fieldsplit_type schur, factorization full, precondition user``
(/root/reference/alfi/solver.py:405-421) and the user Schur PC
``DGMassInv`` = -(nu+gamma) Mp^{-1} (/root/reference/alfi/solver.py:15-38).

For J = [[A, B^T], [B, 0]] the full-factorisation application is

    t = A^{-1} rv
    p = S^{-1} (rq - B t)         with S^{-1} ~= -(nu+gamma) Mp^{-1}
    u = t - A^{-1} (B^T p)

where the two A^{-1} are whatever inner solver the mode provides (dense LU
for "allu", one full-multigrid cycle for "almg").  The AL term gamma >> 1
is what makes the mass-matrix Schur approximation accurate (the point of
the reference's method).
"""

from __future__ import annotations

import jax.numpy as jnp


class SchurPC:
    """apply(r) for residual pytrees r = (rv, rq).

    Parameters
    ----------
    form : NSForm (provides B, B^T, and the DG pressure mass inverse)
    mask_u : (ndofV, d) velocity BC row mask
    solve_A : closure rv -> approx A^{-1} rv on (ndofV, d) arrays; must
        return zero rows at BC dofs for zero-row inputs.
    """

    #: subclasses that never touch ``minv`` (LSC) skip its computation —
    #: SchurPC is constructed inside the jitted linear-step trace, so an
    #: unused pressure_mass_inverse would still be traced every step
    needs_minv = True

    def __init__(self, form, mask_u, solve_A):
        self.form = form
        self.mask_u = mask_u
        self.solve_A = solve_A
        self.minv = form.pressure_mass_inverse() if self.needs_minv \
            else None

    def schur_inverse(self, s, params):
        scale = -(params["nu"] + params["gamma"])
        return scale * self.form.apply_pressure_massinv(self.minv, s)

    def make_apply(self, params):
        form = self.form
        mask_u = self.mask_u
        solve_A = self.solve_A

        def apply(r):
            rv, rq = r
            t = solve_A(mask_u * rv)
            s = rq - form.apply_divergence(t)
            p = self.schur_inverse(s, params)
            w = mask_u * form.apply_pressure_gradient(p)
            u = t - solve_A(w)
            return (u, p)

        return apply


class LSCSchurPC(SchurPC):
    """Least-Squares Commutator Schur approximation — the reference's
    non-AL competitor mode (``--solver-type lsc``,
    /root/reference/alfi/solver.py:447-460: PCLSC with hypre inner
    solves, gamma forced to 0 at :127-128).

    For S = -B A^{-1} B^T the LSC preconditioner is

        S^{-1} ~= -(B B^T)^{-1} (B A B^T) (B B^T)^{-1}

    The reference applies each (B B^T)^{-1} as one hypre AMG V-cycle
    (preonly); the JAX-native analogue here is a short matrix-free CG on
    L = B B^T (L assembled nowhere; B/B^T ride the same element-tensor
    kernels as everything else).  For enclosed flows the constant
    pressure lies in null(B^T) = null(L); both the CG and the outer
    residual are kept in the orthogonal complement by mean removal.

    Parameters (beyond SchurPC's): ``apply_A`` — the masked velocity
    Jacobian action at the current Newton state, (ndofV, d) -> (ndofV, d).
    """

    needs_minv = False

    def __init__(self, form, mask_u, solve_A, apply_A, has_nullspace,
                 l_iters=30, l_rtol=1e-6):
        super().__init__(form, mask_u, solve_A)
        self.apply_A = apply_A
        self.has_nullspace = has_nullspace
        self.l_iters = l_iters
        self.l_rtol = l_rtol

    def _project(self, q):
        if self.has_nullspace:
            return q - jnp.mean(q)
        return q

    def _solve_L(self, s):
        """(B B^T)^{-1} s by matrix-free CG (hypre-preonly analogue)."""
        from .krylov import cg

        form, mask_u = self.form, self.mask_u

        def L(q):
            return self._project(form.apply_divergence(
                mask_u * form.apply_pressure_gradient(q)))

        x, _ = cg(L, self._project(s), pc=None, rtol=self.l_rtol,
                  atol=0.0, maxit=self.l_iters)
        return self._project(x)

    def schur_inverse(self, s, params):
        form, mask_u = self.form, self.mask_u
        q1 = self._solve_L(s)
        w = mask_u * form.apply_pressure_gradient(q1)
        q2 = form.apply_divergence(mask_u * self.apply_A(w))
        return -self._solve_L(q2)


def pressure_nullspace_projector(Z):
    """Remove the constant-pressure mode (Euclidean, matching PETSc's
    MatNullSpace vector for the basis in
    /root/reference/alfi/problem.py:33-38)."""

    def project(z):
        u, p = z
        return (u, p - jnp.mean(p))

    return project
