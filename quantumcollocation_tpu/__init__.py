"""quantumcollocation_tpu — batched direct collocation for quantum optimal control.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
QuantumCollocation.jl stack (see SURVEY.md): quantum control problems are
nonlinear programs over knot-point trajectories (U_t, a_t, Δt_t) with dynamics
enforced as collocation defects, solved by an in-house batched primal-dual
interior-point method whose block-tridiagonal KKT system is factorized
stage-wise — all knots, all batch instances, and all multi-start seeds in
parallel on the accelerator.
"""

from .quantum import *  # noqa: F401,F403
from .quantum import __all__ as _quantum_all
from .trajectory import *  # noqa: F401,F403
from .trajectory import __all__ as _trajectory_all
from .dynamics import *  # noqa: F401,F403
from .dynamics import __all__ as _dynamics_all
from .objectives import *  # noqa: F401,F403
from .objectives import __all__ as _objectives_all
from .solver import *  # noqa: F401,F403
from .solver import __all__ as _solver_all
from .problems import *  # noqa: F401,F403
from .problems import __all__ as _problems_all
from .systems import *  # noqa: F401,F403
from .systems import __all__ as _systems_all
from .parallel import *  # noqa: F401,F403
from .parallel import __all__ as _parallel_all
from .utils import *  # noqa: F401,F403
from .utils import __all__ as _utils_all

__version__ = "0.1.0"

__all__ = (
    list(_quantum_all)
    + list(_trajectory_all)
    + list(_dynamics_all)
    + list(_objectives_all)
    + list(_solver_all)
    + list(_problems_all)
    + list(_systems_all)
    + list(_parallel_all)
    + list(_utils_all)
)
