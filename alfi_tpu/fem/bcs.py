"""Dirichlet boundary conditions for the mixed (u, p) system.

JAX-native replacement for firedrake.DirichletBC as used by the problem
definitions (/root/reference/examples/ldc2d/ldc2d.py:22-25).  A BC is
resolved ONCE on the host into (dof indices, nodal values); the device sees
only a 0/1 row mask pytree and a values pytree:

* solutions are kept feasible:      z   <- mask * z + values
* residual / Jacobian rows vanish:  F   <- mask * F
* Newton updates stay tangent:      J v <- mask * Jvp(mask * v) + (1-mask) v

which is exactly the eliminated-row treatment PETSc applies for the
reference (identity rows on constrained dofs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import real_dtype


class DirichletBC:
    """value on the closure of tagged boundary facets of one (sub)space.

    Parameters
    ----------
    space : FunctionSpace | VectorFunctionSpace
    value : constant scalar / length-d sequence, or callable
        ``value(x)`` mapping dof coordinates ``(n, d)`` to nodal values
        (``(n,)`` scalar space, ``(n, d)`` vector space).  Nodal
        interpolation matches Firedrake's DirichletBC on nodal elements.
    tags : int | sequence[int] | None
        boundary markers; None = the whole exterior boundary.
    nodes : optional explicit dof indices (overrides tags) — the analogue
        of the pressure-pinning trick in /root/reference/alfi/solver.py:184-189.
    """

    def __init__(self, space, value, tags=None, nodes=None):
        self.space = space
        self.value = value
        self.tags = tags
        if nodes is not None:
            self.dofs = np.asarray(nodes, dtype=np.int64)
        else:
            self.dofs = np.asarray(space.boundary_dofs(tags), dtype=np.int64)

    def nodal_values(self):
        x = self.space.dof_coords[self.dofs]
        vec = getattr(self.space, "value_size", None)
        if callable(self.value):
            vals = np.asarray(self.value(x), dtype=np.float64)
        else:
            vals = np.broadcast_to(
                np.asarray(self.value, dtype=np.float64),
                (len(self.dofs), vec) if vec else (len(self.dofs),),
            )
        return vals


class BCSet:
    """All BCs of a mixed space, compiled to mask/value pytrees.

    BCs are applied in list order; a dof constrained twice takes the LAST
    value (Firedrake's sequential-application semantics, relevant at e.g.
    lid-cavity corners)."""

    def __init__(self, Z, bcs, pin_pressure=False):
        self.Z = Z
        V, Q = Z.V, Z.Q
        d = V.value_size
        mask_u = np.ones((V.ndof, d))
        vals_u = np.zeros((V.ndof, d))
        mask_p = np.ones((Q.ndof,))
        vals_p = np.zeros((Q.ndof,))
        for bc in bcs:
            vals = bc.nodal_values()
            if bc.space is V:
                mask_u[bc.dofs] = 0.0
                vals_u[bc.dofs] = vals
            elif bc.space is Q:
                mask_p[bc.dofs] = 0.0
                vals_p[bc.dofs] = vals
            else:
                raise ValueError("BC space is not a component of Z")
        if pin_pressure:
            mask_p[0] = 0.0
            vals_p[0] = 0.0
        self.mask = (
            jnp.asarray(mask_u, dtype=real_dtype),
            jnp.asarray(mask_p, dtype=real_dtype),
        )
        self.values = (
            jnp.asarray(vals_u, dtype=real_dtype),
            jnp.asarray(vals_p, dtype=real_dtype),
        )

    # ------------------------------------------------------------------
    def apply(self, z):
        """Overwrite constrained dofs with their boundary values."""
        return jax.tree.map(
            lambda m, g, x: m * x + g, self.mask, self.values, z
        )

    def zero_rows(self, r):
        """Zero residual rows at constrained dofs (bc.zero of the
        reference's residual check, /root/reference/alfi/solver.py:283-287)."""
        return jax.tree.map(jnp.multiply, self.mask, r)

    def zero(self, z):
        """Zero constrained dofs (homogeneous form of apply)."""
        return jax.tree.map(jnp.multiply, self.mask, z)

    def identity_rows(self, r, v):
        """mask*r + (1-mask)*v : eliminated-row Jacobian action."""
        return jax.tree.map(
            lambda m, rr, vv: m * rr + (1.0 - m) * vv, self.mask, r, v
        )
