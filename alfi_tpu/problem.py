"""Flow-problem abstraction.

JAX-native analogue of the reference's NavierStokesProblem
(/root/reference/alfi/problem.py:5-58): a problem supplies the base mesh,
boundary conditions, characteristic scales, optional forcing (MMS) and
optional patch-sweep direction; the solver supplies everything else.
"""

from __future__ import annotations

import numpy as np

from .mesh import mesh_hierarchy


class NavierStokesProblem:
    def mesh(self):
        raise NotImplementedError

    def mesh_hierarchy(self, hierarchy, nref):
        return mesh_hierarchy(self.mesh(), hierarchy, nref)

    def bcs(self, Z):
        """List of DirichletBC on Z.V / Z.Q."""
        raise NotImplementedError

    def has_nullspace(self):
        """True when the boundary fully encloses the flow (pressure only
        defined up to a constant)."""
        raise NotImplementedError

    def char_velocity(self):
        return 1.0

    def char_length(self):
        return 1.0

    def rhs(self):
        """Optional forcing: callable (x (nq, d), params) -> (f_v, f_q),
        used by MMS problems (/root/reference/examples/mmsldc2d)."""
        return None

    def relaxation_direction(self):
        """Lexicographic sweep spec like "0+:1-" for multiplicative
        patch smoothers (/root/reference/examples/ldc2d/ldc2d.py:39)."""
        return None

    def actual_solution(self, Z):
        """MMS problems: (u_exact(x), p_exact(x)) callables."""
        raise NotImplementedError

    def mesh_size(self, mesh, domain_type="cell"):
        if domain_type == "cell":
            return mesh.cell_sizes()
        areas = mesh.facet_areas()
        return areas if mesh.dim == 2 else np.sqrt(areas)
