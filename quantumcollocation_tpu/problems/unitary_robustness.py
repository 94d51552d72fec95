"""UnitaryRobustnessProblem — first-order robustness against an error
Hamiltonian.

Re-implements /root/reference/src/problem_templates/unitary_robustness_problem.jl:
adds UnitaryRobustnessObjective(H_error) and a final-fidelity constraint
(default: current fidelity), with a warm-start overload
UnitaryRobustnessProblem(H_error, prob[, system]).

Stage-local lowering: the nonseparable Magnus cost is accumulated as an extra
trajectory state via RobustnessAccumulatorIntegrator (see
dynamics/integrators.py), keeping the KKT block-tridiagonal.
"""

from __future__ import annotations

import copy

import numpy as np

from ..dynamics.integrators import RobustnessAccumulatorIntegrator
from ..objectives.constraints import (
    FinalUnitaryFidelityConstraint,
    FinalUnitaryFreePhaseFidelityConstraint,
)
from ..objectives.objectives import Objective, ObjectiveTerm
from ..quantum.embedded import EmbeddedOperator
from ..quantum.fidelities import (
    iso_vec_unitary_fidelity,
    iso_vec_unitary_free_phase_fidelity,
)
from ..solver.options import PiccoloOptions, SolverOptions
from ..trajectory.named_trajectory import NamedTrajectory
from .problem import QuantumControlProblem

__all__ = ["UnitaryRobustnessProblem"]


def UnitaryRobustnessProblem(
    H_error,
    trajectory,
    system=None,
    objective=None,
    integrators=None,
    constraints=None,
    *,
    unitary_name: str = "Ũ⃗",
    control_name: str = "a",
    final_fidelity: float | None = None,
    phase_name: str = "ϕ",
    phase_operators=None,
    ipopt_options: SolverOptions | None = None,
    piccolo_options: PiccoloOptions | None = None,
    subspace=None,
    accumulator_name: str = "m_rob",
    **kwargs,
) -> QuantumControlProblem:
    """Call forms:

    UnitaryRobustnessProblem(H_error, traj, system, objective, integrators,
                             constraints; ...)
    UnitaryRobustnessProblem(H_error, prob[, system]; ...)  # warm start
    """
    if isinstance(trajectory, QuantumControlProblem):
        prob = trajectory
        system = system or prob.system
        objective = objective if objective is not None else prob.get_objective()
        integrators = integrators if integrators is not None else prob.integrators
        constraints = (
            list(constraints)
            if constraints is not None
            else prob.get_constraints()
        )
        ipopt_options = ipopt_options or copy.deepcopy(prob.ipopt_options)
        piccolo_options = piccolo_options or copy.deepcopy(prob.piccolo_options)
        trajectory = prob.trajectory.copy()

    assert isinstance(trajectory, NamedTrajectory)
    assert unitary_name in trajectory.names
    constraints = list(constraints or [])
    integrators = list(integrators or [])
    ipopt_options = ipopt_options or SolverOptions()
    piccolo_options = piccolo_options or PiccoloOptions()

    H_error_mat = (
        np.asarray(H_error.operator)
        if isinstance(H_error, EmbeddedOperator)
        else np.asarray(H_error)
    )

    # augment trajectory with the robustness accumulator state M (iso-vec)
    n2 = trajectory.comp_size(unitary_name)
    comps = {n: np.asarray(trajectory[n]) for n in trajectory.names}
    comps[accumulator_name] = np.zeros((trajectory.T, n2))
    initial = dict(trajectory.initial)
    initial[accumulator_name] = np.zeros(n2)
    traj = NamedTrajectory(
        comps,
        controls=trajectory.controls,
        timestep=trajectory.timestep,
        bounds=dict(trajectory.bounds),
        initial=initial,
        final=dict(trajectory.final),
        goal=dict(trajectory.goal),
        global_data=dict(trajectory.global_data),
    )

    integrators.append(
        RobustnessAccumulatorIntegrator(
            state_name=unitary_name,
            accumulator_name=accumulator_name,
            control_name=control_name,
            H_error=H_error_mat,
        )
    )

    # terminal robustness cost ||M_T||^2 / (N * T_total)^2
    N_dim = int(round((n2 / 2) ** 0.5))
    T_total = float(np.asarray(trajectory.duration()))
    scale = 1.0 / (N_dim * max(T_total, 1e-12)) ** 2
    start, stop = traj.components[accumulator_name]

    def rob_fn(zT, globals_dict):
        m = zT[start:stop]
        return scale * (m @ m)

    objective = objective + Objective(
        (ObjectiveTerm("terminal", rob_fn, 1.0, "unitary_robustness"),)
    )

    U_T = trajectory[unitary_name][-1]
    U_G = np.asarray(trajectory.goal[unitary_name])
    if phase_operators is None:
        if final_fidelity is None:
            final_fidelity = float(
                iso_vec_unitary_fidelity(U_T, U_G, subspace=subspace)
            )
        constraints.append(
            FinalUnitaryFidelityConstraint(
                unitary_name, final_fidelity, subspace=subspace
            )
        )
    else:
        if final_fidelity is None:
            final_fidelity = float(
                iso_vec_unitary_free_phase_fidelity(
                    U_T,
                    U_G,
                    trajectory.global_data[phase_name],
                    phase_operators,
                    subspace=subspace,
                )
            )
        constraints.append(
            FinalUnitaryFreePhaseFidelityConstraint(
                unitary_name,
                phase_name,
                phase_operators,
                final_fidelity,
                subspace=subspace,
            )
        )

    return QuantumControlProblem(
        traj,
        objective,
        integrators,
        constraints=constraints,
        ipopt_options=ipopt_options,
        piccolo_options=piccolo_options,
        control_name=control_name,
        system=system,
        **kwargs,
    )
