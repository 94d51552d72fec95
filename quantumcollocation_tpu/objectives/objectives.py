"""Objective terms and algebra.

Mirrors the reference's Objective surface (SURVEY.md §2b; call sites:
/root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:132-153,
unitary_sampling_problem.jl:116-125): objectives support `J1 + J2` and
`weight * J`, and evaluate on a trajectory via `J.L(traj)`.

Each term is classified by its stage structure so the problem compiler can
lower it into the StageNLP IR without breaking the block-tridiagonal KKT:
  - "stage":    fn(z_t, t) -> scalar, summed over all knots
  - "pair":     fn(z_t, z_{t+1}, t) -> scalar, summed over t = 0..T-2
  - "terminal": fn(z_T, globals) -> scalar
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax.numpy as jnp
import numpy as np

from ..quantum.fidelities import (
    iso_fidelity,
    iso_vec_unitary_fidelity,
    iso_vec_unitary_free_phase_fidelity,
)

__all__ = [
    "Objective",
    "ObjectiveTerm",
    "NullObjective",
    "UnitaryInfidelityObjective",
    "UnitaryFreePhaseInfidelityObjective",
    "QuantumStateObjective",
    "DensityOperatorPureStateInfidelityObjective",
    "UnitaryRobustnessObjective",
    "MinimumTimeObjective",
    "QuadraticRegularizer",
    "QuadraticSmoothnessRegularizer",
    "PairwiseQuadraticRegularizer",
    "L1Regularizer",
]


@dataclasses.dataclass(frozen=True)
class ObjectiveTerm:
    kind: str  # "stage" | "pair" | "terminal"
    fn: Callable
    weight: float = 1.0
    label: str = ""

    def scaled(self, factor):
        return dataclasses.replace(self, weight=self.weight * float(factor))


@dataclasses.dataclass(frozen=True)
class Objective:
    terms: tuple = ()

    def __add__(self, other):
        if other is None or other == 0:
            return self
        return Objective(self.terms + other.terms)

    __radd__ = __add__

    def __mul__(self, factor):
        return Objective(tuple(t.scaled(factor) for t in self.terms))

    __rmul__ = __mul__

    # ---- evaluation on a NamedTrajectory (convenience / tests) --------- #
    def L(self, traj):
        """Evaluate the total objective on a trajectory."""
        Z = traj.data
        T = traj.T
        total = 0.0
        globals_dict = dict(traj.global_data)
        for term in self.terms:
            if term.kind == "stage":
                vals = jnp.stack(
                    [term.fn(Z[t], t) for t in range(T)]
                )
                total += term.weight * jnp.sum(vals)
            elif term.kind == "pair":
                vals = jnp.stack(
                    [term.fn(Z[t], Z[t + 1], t) for t in range(T - 1)]
                )
                total += term.weight * jnp.sum(vals)
            elif term.kind == "terminal":
                total += term.weight * term.fn(Z[-1], globals_dict)
        return total


def NullObjective():
    return Objective(())


def _slice(traj, name):
    start, stop = traj.components[name]
    return start, stop


# --------------------------------------------------------------------------- #
# fidelity objectives
# --------------------------------------------------------------------------- #


def UnitaryInfidelityObjective(
    name, traj, Q=100.0, *, subspace=None, eval_hessian=True
):
    """Q * |1 - F(U_T, U_goal)| with F = |tr(U_goal^† U_T)|/N (on subspace).

    Reference: unitary_smooth_pulse_problem.jl:132-137 (formula :25-28).
    """
    start, stop = _slice(traj, name)
    goal = jnp.asarray(traj.goal[name])
    sub = None if subspace is None else tuple(subspace)

    def fn(zT, globals_dict):
        F = iso_vec_unitary_fidelity(zT[start:stop], goal, subspace=sub)
        return jnp.abs(1.0 - F)

    return Objective(
        (ObjectiveTerm("terminal", fn, float(Q), f"unitary_infidelity[{name}]"),)
    )


def UnitaryFreePhaseInfidelityObjective(
    name,
    phase_name,
    phase_operators,
    traj,
    Q=100.0,
    *,
    subspace=None,
    eval_hessian=True,
):
    """Infidelity up to optimizable global phases exp(i phi_k G_k) stored in
    trajectory global data (reference: unitary_smooth_pulse_problem.jl:139-144)."""
    start, stop = _slice(traj, name)
    goal = jnp.asarray(traj.goal[name])
    ops = np.stack([np.asarray(op) for op in phase_operators])
    sub = None if subspace is None else tuple(subspace)

    def fn(zT, globals_dict):
        phases = globals_dict[phase_name]
        F = iso_vec_unitary_free_phase_fidelity(
            zT[start:stop], goal, phases, ops, subspace=sub
        )
        return jnp.abs(1.0 - F)

    return Objective(
        (
            ObjectiveTerm(
                "terminal", fn, float(Q), f"free_phase_infidelity[{name}]"
            ),
        )
    )


def QuantumStateObjective(name, traj, Q=100.0, *, eval_hessian=True):
    """Q * (1 - |<goal|psi_T>|^2) (reference: quantum_state_smooth_pulse_problem.jl:133)."""
    start, stop = _slice(traj, name)
    goal = jnp.asarray(traj.goal[name])

    def fn(zT, globals_dict):
        return 1.0 - iso_fidelity(zT[start:stop], goal)

    return Objective(
        (ObjectiveTerm("terminal", fn, float(Q), f"state_infidelity[{name}]"),)
    )


def DensityOperatorPureStateInfidelityObjective(name, psi_goal, *, Q=100.0, traj=None):
    """Q * (1 - <psi|rho_T|psi>) (reference: density_operator_smooth_pulse_problem.jl:55)."""
    assert traj is not None, "traj required to resolve component slices"
    from ..quantum.fidelities import iso_vec_density_pure_state_fidelity

    start, stop = _slice(traj, name)
    # real-arithmetic iso-vec fidelity: no complex array exists device-side,
    # even under eager evaluation
    psi = np.asarray(psi_goal, dtype=complex)

    def fn(zT, globals_dict):
        return 1.0 - iso_vec_density_pure_state_fidelity(zT[start:stop], psi)

    return Objective(
        (ObjectiveTerm("terminal", fn, float(Q), f"density_infidelity[{name}]"),)
    )


def UnitaryRobustnessObjective(
    *, H_error=None, accumulator_name="m_rob", traj=None, eval_hessian=True
):
    """First-order (Magnus) robustness cost against an error Hamiltonian.

    Stage-local lowering: the nonseparable cost
    || sum_t dt_t U_t^† H_err U_t ||_F^2 / (N * T_total)^2 is made stage-local
    by accumulating M_{t+1} = M_t + dt_t iso_vec(U_t^† H_e U_t) as extra
    trajectory state with a defect row (see RobustnessAccumulatorIntegrator in
    the robustness template); this objective is then a terminal cost on the
    accumulator component.  Reference surface: unitary_robustness_problem.jl:47-50.
    """
    assert traj is not None, "traj required to resolve component slices"
    start, stop = _slice(traj, accumulator_name)

    def fn(zT, globals_dict):
        m = zT[start:stop]
        return jnp.sum(m**2)

    return Objective(
        (ObjectiveTerm("terminal", fn, 1.0, "unitary_robustness"),)
    )


# --------------------------------------------------------------------------- #
# time and regularization objectives
# --------------------------------------------------------------------------- #


def MinimumTimeObjective(traj, *, D=1.0, timestep_name="Δt", eval_hessian=True):
    """D * sum_t dt_t (reference: unitary_minimum_time_problem.jl:67-69)."""
    assert isinstance(traj.timestep, str), (
        "MinimumTimeObjective requires a free-time trajectory"
    )
    start, stop = _slice(traj, traj.timestep)
    T = traj.T

    def fn(z, t):
        return jnp.where(t < T - 1, jnp.sum(z[start:stop]), 0.0)

    return Objective((ObjectiveTerm("stage", fn, float(D), "minimum_time"),))


def QuadraticRegularizer(
    name, traj, R=1.0, *, baseline=None, timestep_name="Δt", indices=None,
    eval_hessian=True,
):
    """(1/2) sum_t R * ||v_t - baseline||^2
    (reference: unitary_smooth_pulse_problem.jl:151-153; baseline offset used
    by the direct-sum template, unitary_direct_sum_problem.jl:150)."""
    start, stop = _slice(traj, name)
    k = stop - start
    Rvec = jnp.broadcast_to(jnp.asarray(R, dtype=float), (k,))
    base = (
        jnp.zeros((k,))
        if baseline is None
        else jnp.broadcast_to(jnp.asarray(baseline, dtype=float), (k,))
    )
    idx = None if indices is None else jnp.asarray(indices)

    def fn(z, t):
        v = z[start:stop] - base
        if idx is not None:
            v = v[idx]
            r = Rvec[idx]
        else:
            r = Rvec
        return 0.5 * jnp.sum(r * v**2)

    return Objective((ObjectiveTerm("stage", fn, 1.0, f"quad_reg[{name}]"),))


def QuadraticSmoothnessRegularizer(name, traj, R=1.0, *, eval_hessian=True):
    """(1/2) sum_t R * ||v_{t+1} - v_t||^2
    (reference: unitary_smooth_pulse_problem.jl:324)."""
    start, stop = _slice(traj, name)
    k = stop - start
    Rvec = jnp.broadcast_to(jnp.asarray(R, dtype=float), (k,))

    def fn(zt, ztp1, t):
        dv = ztp1[start:stop] - zt[start:stop]
        return 0.5 * jnp.sum(Rvec * dv**2)

    return Objective((ObjectiveTerm("pair", fn, 1.0, f"smooth_reg[{name}]"),))


def PairwiseQuadraticRegularizer(traj, Q, graph: Sequence, *, eval_hessian=True):
    """sum_{(i,j) in graph} Q * ||v_i(t) - v_j(t)||^2 across suffixed
    components (reference: unitary_direct_sum_problem.jl:147).

    graph: sequence of (name_i, name_j) component-name pairs.
    """
    slices = []
    for name_i, name_j in graph:
        slices.append((_slice(traj, name_i), _slice(traj, name_j)))
    Qv = float(Q) if np.isscalar(Q) else None
    Qs = None if Qv is not None else [float(q) for q in Q]

    def fn(z, t):
        total = 0.0
        for e, ((si, ei), (sj, ej)) in enumerate(slices):
            q = Qv if Qv is not None else Qs[e]
            dv = z[si:ei] - z[sj:ej]
            total = total + 0.5 * q * jnp.sum(dv**2)
        return total

    return Objective((ObjectiveTerm("stage", fn, 1.0, "pairwise_quad_reg"),))


def L1Regularizer(
    constraints: list,
    name: str,
    traj,
    *,
    R=1.0,
    R_value=None,
    indices=None,
    slack_name=None,
    eval_hessian=True,
):
    """L1 penalty R * sum_t sum_i |v_i(t)| via slack variables.

    Returns (J, new_traj): appends slack inequality constraints to
    `constraints` (mutated, mirroring the reference's L1Regularizer! at
    /root/reference/src/problem_templates/_problem_templates.jl:46-53) and
    returns the trajectory augmented with the slack component.

    Formulation: slack s >= 0 with s - v >= 0, s + v >= 0 per index and cost
    R * sum s — stage-local, so the KKT stays block-tridiagonal.
    """
    from .constraints import L1SlackConstraint

    if R_value is not None:
        R = R_value
    start, stop = traj.components[name]
    k = stop - start
    if indices is None:
        indices = list(range(k))
    indices = list(indices)
    slack_name = slack_name or f"{name}_l1_slack"

    v0 = np.abs(np.asarray(traj[name]))[:, indices] + 1e-3
    comps = {n: np.asarray(traj[n]) for n in traj.names}
    comps[slack_name] = v0
    new_traj = type(traj)(
        comps,
        controls=traj.controls,
        timestep=traj.timestep,
        bounds=dict(traj.bounds),
        initial=dict(traj.initial),
        final=dict(traj.final),
        goal=dict(traj.goal),
        global_data=dict(traj.global_data),
    )

    constraints.append(L1SlackConstraint(name, slack_name, tuple(indices)))

    s_start, s_stop = new_traj.components[slack_name]
    Rvec = jnp.broadcast_to(jnp.asarray(R, dtype=float), (len(indices),))

    def fn(z, t):
        return jnp.sum(Rvec * z[s_start:s_stop])

    J = Objective((ObjectiveTerm("stage", fn, 1.0, f"l1_reg[{name}]"),))
    return J, new_traj
