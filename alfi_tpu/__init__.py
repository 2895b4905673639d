"""alfi_tpu — JAX-native Reynolds-robust Navier-Stokes solvers.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
florianwechsung/alfi (augmented-Lagrangian preconditioned Newton-FGMRES
with patch-smoother multigrid and Schoeberl transfers), with no
Firedrake/PETSc underneath: host-side numpy topology compilation + pure
jitted device solvers.
"""

from . import config  # noqa: F401  (enables x64 before anything else)

__version__ = "0.1.0"

from .driver import get_default_parser, get_solver, run_solver  # noqa: E402
from .fem.bcs import BCSet, DirichletBC  # noqa: E402
from .problem import NavierStokesProblem  # noqa: E402
from .solver import ConstantPressureSolver, ScottVogeliusSolver  # noqa: E402

# the reference's flat `from alfi import *` surface also exposes the
# relaxation/transfer/hierarchy building blocks
# (/root/reference/alfi/__init__.py); these are their analogues
from .mesh.hierarchy import MeshHierarchy, mesh_hierarchy  # noqa: E402
from .mg.bubble import BubbleTransfer  # noqa: E402
from .mg.patches import (  # noqa: E402
    macrostar_patches,
    star_patches,
)
from .mg.schoeberl import SchoeberlTransfer  # noqa: E402
