"""Collocation integrators: defect definitions P(z_t, z_{t+1}) = 0.

Each integrator names trajectory components and contributes rows to the
stacked defect F_t(z_t, z_{t+1}).  All defects are *independent across t*
given the decision vector, so the solver evaluates them for all knots and all
batch instances in parallel (vmap), unlike a rollout which is sequential.

Reference surface (inferred; call sites cited in SURVEY.md §2b):
UnitaryPadeIntegrator / UnitaryExponentialIntegrator
(/root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:163-173),
QuantumState*Integrator (quantum_state_smooth_pulse_problem.jl:146-159),
DensityOperatorExponentialIntegrator (density_operator_smooth_pulse_problem.jl:104-106),
DerivativeIntegrator (unitary_smooth_pulse_problem.jl:177-178).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..quantum.systems import OpenQuantumSystem, QuantumSystem
from .expm import (
    default_num_squarings,
    expm_squaring,
    pade_numerator_denominator,
)

__all__ = [
    "AbstractIntegrator",
    "UnitaryExponentialIntegrator",
    "UnitaryPadeIntegrator",
    "QuantumStateExponentialIntegrator",
    "QuantumStatePadeIntegrator",
    "DensityOperatorExponentialIntegrator",
    "DerivativeIntegrator",
    "TimeStepEqualityIntegrator",
    "RobustnessAccumulatorIntegrator",
]


def _norm_bound(system: QuantumSystem, drive_bounds, dt_max: float) -> float:
    """Host-side upper bound on ||G(a) * dt|| used to pick static squarings."""
    G0 = np.linalg.norm(np.asarray(system.G_drift), 2)
    Gs = [
        np.linalg.norm(np.asarray(system.G_drives[j]), 2)
        for j in range(system.n_drives)
    ]
    if drive_bounds is None:
        drive_bounds = [1.0] * system.n_drives
    bound = G0 + sum(b * g for b, g in zip(drive_bounds, Gs))
    return float(bound * dt_max)


@dataclasses.dataclass
class AbstractIntegrator:
    """Base: named defect block over (z_t, z_{t+1})."""

    def defect_dim(self, traj) -> int:
        raise NotImplementedError

    def defect(self, zt, ztp1, traj):
        """Return (defect_dim,) residual; zt/ztp1 are full knot rows (dim,)."""
        raise NotImplementedError

    def add_suffix(self, suffix: str):
        """Return a copy with component names suffixed (direct-sum support)."""
        new = dataclasses.replace(self)
        for field in (
            "state_name",
            "control_name",
            "x_name",
            "dx_name",
            "accumulator_name",
            "timestep_name",
        ):
            if hasattr(new, field) and getattr(new, field) is not None:
                setattr(new, field, getattr(new, field) + suffix)
        return new


def _get(traj, z, name):
    start, stop = traj.components[name]
    return z[..., start:stop]


def _dt(traj, z, timestep_name=None):
    name = timestep_name if timestep_name is not None else (
        traj.timestep if isinstance(traj.timestep, str) else None
    )
    if name is not None and name in traj.components:
        return _get(traj, z, name)[..., 0]
    if isinstance(traj.timestep, str):
        return _get(traj, z, traj.timestep)[..., 0]
    return jnp.asarray(traj.timestep, dtype=z.dtype)


@dataclasses.dataclass
class UnitaryExponentialIntegrator(AbstractIntegrator):
    """Defect: iso_vec(U_{t+1}) - kron-free [exp(G(a_t) dt_t)] applied to U_t.

    The iso-vec state is reshaped to the (2N, N) iso operator so the
    propagator application is one (2N,2N)@(2N,N) matmul per knot — batched
    over knots and instances.
    """

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 8
    num_squarings: int | None = None
    drive_bounds: Any = None
    dt_max: float = 1.0
    timestep_name: Any = None

    def __post_init__(self):
        if self.num_squarings is None:
            self.num_squarings = default_num_squarings(
                _norm_bound(self.system, self.drive_bounds, self.dt_max),
                self.order,
            )

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def propagator(self, zt, traj):
        a = _get(traj, zt, self.control_name)
        dt = _dt(traj, zt, self.timestep_name)
        G = self.system.generator(a)
        return expm_squaring(
            G * dt, order=self.order, num_squarings=self.num_squarings
        )

    def defect(self, zt, ztp1, traj):
        n2 = traj.comp_size(self.state_name)
        N = int(round((n2 / 2) ** 0.5))
        U_t = _get(traj, zt, self.state_name).reshape(N, 2 * N).T
        U_tp1 = _get(traj, ztp1, self.state_name).reshape(N, 2 * N).T
        P = self.propagator(zt, traj)
        resid = U_tp1 - P @ U_t
        return resid.T.reshape(-1)


@dataclasses.dataclass
class UnitaryPadeIntegrator(AbstractIntegrator):
    """Implicit Padé defect: q(-X) U_{t+1} - q(X) U_t = 0, X = G(a_t) dt_t.

    Order n in {4, ..., 20} matches the reference's `pade_order`
    (test evidence: pade_order=12 at
    /root/reference/src/problem_templates/unitary_bang_bang_problem.jl:208).
    """

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 4
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        n2 = traj.comp_size(self.state_name)
        N = int(round((n2 / 2) ** 0.5))
        U_t = _get(traj, zt, self.state_name).reshape(N, 2 * N).T
        U_tp1 = _get(traj, ztp1, self.state_name).reshape(N, 2 * N).T
        a = _get(traj, zt, self.control_name)
        dt = _dt(traj, zt, self.timestep_name)
        X = self.system.generator(a) * dt
        A, B = pade_numerator_denominator(X, self.order)
        resid = B @ U_tp1 - A @ U_t
        return resid.T.reshape(-1)


@dataclasses.dataclass
class QuantumStateExponentialIntegrator(AbstractIntegrator):
    """Ket defect: psi_iso_{t+1} - exp(G(a_t) dt_t) psi_iso_t."""

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 8
    num_squarings: int | None = None
    drive_bounds: Any = None
    dt_max: float = 1.0
    timestep_name: Any = None

    def __post_init__(self):
        if self.num_squarings is None:
            self.num_squarings = default_num_squarings(
                _norm_bound(self.system, self.drive_bounds, self.dt_max),
                self.order,
            )

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        psi_t = _get(traj, zt, self.state_name)
        psi_tp1 = _get(traj, ztp1, self.state_name)
        a = _get(traj, zt, self.control_name)
        dt = _dt(traj, zt, self.timestep_name)
        G = self.system.generator(a)
        P = expm_squaring(
            G * dt, order=self.order, num_squarings=self.num_squarings
        )
        return psi_tp1 - P @ psi_t


@dataclasses.dataclass
class QuantumStatePadeIntegrator(AbstractIntegrator):
    """Ket implicit Padé defect: q(-X) psi_{t+1} - q(X) psi_t."""

    state_name: str
    control_name: str
    system: QuantumSystem = None
    order: int = 4
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        psi_t = _get(traj, zt, self.state_name)
        psi_tp1 = _get(traj, ztp1, self.state_name)
        a = _get(traj, zt, self.control_name)
        dt = _dt(traj, zt, self.timestep_name)
        X = self.system.generator(a) * dt
        A, B = pade_numerator_denominator(X, self.order)
        return B @ psi_tp1 - A @ psi_t


@dataclasses.dataclass
class DensityOperatorExponentialIntegrator(AbstractIntegrator):
    """Lindblad defect: rho_iso_{t+1} - exp(D(a_t) dt_t) rho_iso_t."""

    state_name: str
    control_name: str
    system: OpenQuantumSystem = None
    order: int = 8
    num_squarings: int = 6
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.state_name)

    def defect(self, zt, ztp1, traj):
        rho_t = _get(traj, zt, self.state_name)
        rho_tp1 = _get(traj, ztp1, self.state_name)
        a = _get(traj, zt, self.control_name)
        dt = _dt(traj, zt, self.timestep_name)
        D = self.system.lindblad_generator(a)
        P = expm_squaring(
            D * dt, order=self.order, num_squarings=self.num_squarings
        )
        return rho_tp1 - P @ rho_t


@dataclasses.dataclass
class DerivativeIntegrator(AbstractIntegrator):
    """Linear defect: x_{t+1} - x_t - dx_t * dt_t = 0."""

    x_name: str
    dx_name: str
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.x_name)

    def defect(self, zt, ztp1, traj):
        x_t = _get(traj, zt, self.x_name)
        x_tp1 = _get(traj, ztp1, self.x_name)
        dx_t = _get(traj, zt, self.dx_name)
        dt = _dt(traj, zt, self.timestep_name)
        return x_tp1 - x_t - dx_t * dt


@dataclasses.dataclass
class TimeStepEqualityIntegrator(AbstractIntegrator):
    """Defect: dt_{t+1} - dt_t = 0 (implements TimeStepsAllEqualConstraint
    while preserving block-tridiagonal KKT structure; reference constraint at
    /root/reference/src/problem_templates/_problem_templates.jl:59-63)."""

    timestep_name: str = "Δt"

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.timestep_name)

    def defect(self, zt, ztp1, traj):
        return _get(traj, ztp1, self.timestep_name) - _get(
            traj, zt, self.timestep_name
        )


@dataclasses.dataclass
class RobustnessAccumulatorIntegrator(AbstractIntegrator):
    """Accumulator defect for first-order Magnus robustness.

    Makes the nonseparable robustness cost || sum_t dt_t U_t^† H_e U_t ||_F^2
    stage-local: extra state M with defect
        M_{t+1} - M_t - dt_t * iso_vec(U_t^† H_e U_t) = 0,  M_0 = 0,
    so the terminal cost ||M_T||^2 plus these rows reproduces the reference's
    UnitaryRobustnessObjective (call site:
    /root/reference/src/problem_templates/unitary_robustness_problem.jl:47-50)
    while keeping the KKT system block-tridiagonal.
    """

    state_name: str = "Ũ⃗"
    accumulator_name: str = "m_rob"
    control_name: str = "a"
    H_error: Any = None
    timestep_name: Any = None

    def defect_dim(self, traj) -> int:
        return traj.comp_size(self.accumulator_name)

    def defect(self, zt, ztp1, traj):
        from ..quantum.isomorphisms import (
            iso_vec_to_operator,
            operator_to_iso_vec,
        )

        m_t = _get(traj, zt, self.accumulator_name)
        m_tp1 = _get(traj, ztp1, self.accumulator_name)
        dt = _dt(traj, zt, self.timestep_name)
        U = iso_vec_to_operator(_get(traj, zt, self.state_name))
        He = jnp.asarray(self.H_error, dtype=U.dtype)
        V = operator_to_iso_vec(U.conj().T @ He @ U)
        return m_tp1 - m_t - dt * V
