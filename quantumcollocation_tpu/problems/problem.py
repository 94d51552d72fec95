"""QuantumControlProblem: compile trajectory + objective + integrators +
constraints into a StageNLP and solve with the batched interior-point method.

This is the batched analog of the reference's QuantumControlProblem /
QuantumDynamics assembly + Ipopt registration (surface: SURVEY.md §2b,
call sites /root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:181-190
and field uses unitary_minimum_time_problem.jl:117-130).

Lowering decisions (all preserve the block-tridiagonal KKT structure):
- integrators -> stacked defect rows F_t(z_t, z_{t+1})
- TimeStepsAllEqualConstraint -> extra defect rows dt_{t+1} - dt_t
- global variables (free phases) -> appended to every knot row, pinned
  (masked fixed) at t < T-1 and free only at the terminal knot
- trajectory bounds -> IPM barrier bounds; initial/final pins -> fixed masks
- inequality constraints -> per-knot rows with inactive knots masked to +1
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..objectives.constraints import (
    AbstractConstraint,
    FinalUnitaryFreePhaseFidelityConstraint,
    TimeStepsAllEqualConstraint,
)
from ..objectives.objectives import Objective
from ..solver.analytic import build_analytic_dynamics
from ..solver.ipm import InteriorPointSolver
from ..solver.options import PiccoloOptions, SolverOptions
from ..solver.stage_nlp import StageNLP
from ..trajectory.named_trajectory import NamedTrajectory

__all__ = ["QuantumControlProblem"]


class QuantumControlProblem:
    def __init__(
        self,
        traj: NamedTrajectory,
        objective: Objective,
        integrators: Sequence,
        *,
        constraints: Sequence[AbstractConstraint] = (),
        ipopt_options: SolverOptions | None = None,
        piccolo_options: PiccoloOptions | None = None,
        additional_objective: Objective | None = None,
        control_name: str = "a",
        system=None,
    ):
        self.trajectory = traj
        self.integrators = list(integrators)
        self.ipopt_options = ipopt_options or SolverOptions()
        self.piccolo_options = piccolo_options or PiccoloOptions()
        self.system = system
        self.control_name = control_name

        if additional_objective is not None:
            objective = objective + additional_objective
        self.objective = objective

        # lower equal-timestep constraints into defect rows
        self.constraints = []
        for con in constraints:
            if isinstance(con, TimeStepsAllEqualConstraint):
                self.integrators.append(con.as_integrator())
            else:
                self.constraints.append(con)

        self._compile()

    # ------------------------------------------------------------------ #
    def _compile(self):
        traj = self.trajectory
        T, d = traj.T, traj.dim

        # global variables appended to every knot row
        self.global_slices = {}
        off = d
        for gname, gval in traj.global_data.items():
            k = int(np.prod(np.asarray(gval).shape))
            self.global_slices[gname] = (off, off + k)
            off += k
        d_aug = off
        self._d = d
        self._d_aug = d_aug

        # inject global slices into constraints that need them
        for con in self.constraints:
            if isinstance(con, FinalUnitaryFreePhaseFidelityConstraint):
                con.global_slices = self.global_slices

        integrators = self.integrators
        defect_dims = [ig.defect_dim(traj) for ig in integrators]
        s = sum(defect_dims)

        ineq_cons = [c for c in self.constraints if c.ineq_dim(traj) > 0]
        m = sum(c.ineq_dim(traj) for c in ineq_cons)

        terms = self.objective.terms
        stage_terms = [t for t in terms if t.kind == "stage"]
        pair_terms = [t for t in terms if t.kind == "pair"]
        term_terms = [t for t in terms if t.kind == "terminal"]
        gslices = dict(self.global_slices)

        def stage_cost(z, t):
            total = 0.0
            for term in stage_terms:
                total = total + term.weight * term.fn(z, t)
            return jnp.asarray(total, dtype=z.dtype)

        def pair_cost(zt, ztp1, t):
            total = 0.0
            for term in pair_terms:
                total = total + term.weight * term.fn(zt, ztp1, t)
            return jnp.asarray(total, dtype=zt.dtype)

        def terminal_cost(zT):
            globals_dict = {
                name: zT[gs:ge] for name, (gs, ge) in gslices.items()
            }
            total = 0.0
            for term in term_terms:
                total = total + term.weight * term.fn(zT, globals_dict)
            return jnp.asarray(total, dtype=zT.dtype)

        def defect(zt, ztp1, t):
            rows = [ig.defect(zt, ztp1, traj) for ig in integrators]
            return jnp.concatenate(rows)

        def ineq(z, t):
            if m == 0:
                return jnp.zeros((0,), dtype=z.dtype)
            rows = [c.ineq(z, t, traj) for c in ineq_cons]
            return jnp.concatenate(rows)

        # ---- bounds / pins / initial values ---- #
        lb = np.full((T, d_aug), -np.inf)
        ub = np.full((T, d_aug), np.inf)
        build_pins = self.piccolo_options.build_trajectory_constraints
        if build_pins:
            for name, (lo, hi) in traj.bounds.items():
                sl = traj.comp_slice(name)
                lb[:, sl] = lo[None, :]
                ub[:, sl] = hi[None, :]

        free = np.ones((T, d_aug), dtype=bool)
        z0 = np.zeros((T, d_aug))
        z0[:, :d] = np.asarray(traj.data)

        if build_pins:
            for name, val in traj.initial.items():
                sl = traj.comp_slice(name)
                z0[0, sl] = val
                free[0, sl] = False
            for name, val in traj.final.items():
                sl = traj.comp_slice(name)
                z0[T - 1, sl] = val
                free[T - 1, sl] = False

        # globals: free only at the terminal knot
        for gname, (gs, ge) in gslices.items():
            free[: T - 1, gs:ge] = False
            z0[T - 1, gs:ge] = np.asarray(traj.global_data[gname]).reshape(-1)

        self.nlp = StageNLP(
            T=T,
            d=d_aug,
            s=s,
            m=m,
            stage_cost=stage_cost,
            pair_cost=pair_cost,
            terminal_cost=terminal_cost,
            defect=defect,
            ineq=ineq,
            lb=lb,
            ub=ub,
            free_mask=free,
            z0=z0,
            nl_coords=(
                self._nonlinear_defect_coords()
                if self.piccolo_options.jacobian_structure
                else None
            ),
            analytic=(
                build_analytic_dynamics(traj, integrators, d_aug)
                if self.piccolo_options.jacobian_structure
                else None
            ),
        )
        self.solver = InteriorPointSolver(
            self.nlp,
            self._solver_options(),
            exact_hessian=self.piccolo_options.eval_hessian,
        )
        self.result = None

    def _solver_options(self) -> SolverOptions:
        return self.ipopt_options

    def _nonlinear_defect_coords(self):
        """Knot-row coordinate indices where defects are nonlinear.

        Exp/Padé defects are nonlinear only in (controls, timestep);
        derivative-chain defects bilinear in (dx, timestep); the robustness
        accumulator quadratic in the unitary state.  Unknown integrator types
        disable the structured-Hessian path (returns None -> dense fallback).
        """
        from ..dynamics import integrators as igs

        traj = self.trajectory
        tname = traj.timestep if isinstance(traj.timestep, str) else None
        idx = set()

        def add(name):
            if name is not None and name in traj.components:
                start, stop = traj.components[name]
                idx.update(range(start, stop))

        for ig in self.integrators:
            ig_t = getattr(ig, "timestep_name", None) or tname
            if isinstance(
                ig,
                (
                    igs.UnitaryExponentialIntegrator,
                    igs.UnitaryPadeIntegrator,
                    igs.QuantumStateExponentialIntegrator,
                    igs.QuantumStatePadeIntegrator,
                    igs.DensityOperatorExponentialIntegrator,
                ),
            ):
                add(ig.control_name)
                add(ig_t)
            elif isinstance(ig, igs.DerivativeIntegrator):
                add(ig.dx_name)
                add(ig_t)
            elif isinstance(ig, igs.RobustnessAccumulatorIntegrator):
                add(ig.state_name)
                add(ig_t)
            elif isinstance(ig, igs.TimeStepEqualityIntegrator):
                continue  # linear
            else:
                return None  # unknown integrator: dense Hessian fallback
        return tuple(sorted(idx))

    # ------------------------------------------------------------------ #
    def initial_decision(self, batch: int = 1):
        """(batch, T, d_aug) initial decision tensor from the trajectory."""
        z0 = jnp.asarray(self.nlp.z0)
        return jnp.broadcast_to(z0[None], (batch, *z0.shape))

    def write_back(self, Z_row) -> NamedTrajectory:
        """Build a trajectory carrying the solution Z_row (T, d_aug)."""
        traj = self.trajectory
        data = Z_row[:, : self._d]
        new_globals = {
            name: Z_row[traj.T - 1, gs:ge]
            for name, (gs, ge) in self.global_slices.items()
        }
        globals_dict = dict(traj.global_data)
        globals_dict.update(new_globals)
        return traj.with_data(data, global_data=globals_dict)

    def solve(
        self,
        *,
        max_iter: int | None = None,
        callback=None,
        segment_iters: int | None = None,
    ):
        """Solve and write the optimum back into `self.trajectory`.

        Mirrors the reference's `solve!(prob; max_iter, callback)`
        (README.md:115; callback protocol docs/literate/man/ipopt_callbacks.jl).
        segment_iters splits the device loop into resumable segments for
        call-duration-capped runtimes (see InteriorPointSolver.solve).
        """
        res = self.solver.solve(
            self.initial_decision(1),
            max_iter=max_iter,
            callback=callback,
            segment_iters=segment_iters,
        )
        self.result = res
        self.trajectory = self.write_back(np.asarray(res.Z[0]))
        if self.ipopt_options.print_level >= 3:
            print(
                f"[qct] converged={bool(res.converged[0])} "
                f"iters={int(res.n_iter[0])} kkt_err={float(res.kkt_err[0]):.3e} "
                f"obj={float(res.objective[0]):.6e}"
            )
        return self

    def solve_batched(
        self,
        Z0,
        *,
        max_iter: int | None = None,
        segment_iters: int | None = None,
    ):
        """Solve a batch of initial decisions (B, T, d_aug); returns IPMResult."""
        return self.solver.solve(
            Z0, max_iter=max_iter, segment_iters=segment_iters
        )

    def multistart_initial_decisions(
        self, n_seeds: int, *, sigma: float = 0.1, rng=None
    ):
        """(n_seeds, T, d_aug) initial decisions with DIVERSE, dynamics-
        consistent seeds: per seed, the base controls are perturbed, the
        derivative chain recomputed, and every dynamics state component
        ROLLED OUT under the perturbed controls.  Seeds therefore start
        feasible (zero defects) in different basins — perturbing controls
        alone while sharing the geodesic state path collapses all seeds into
        one basin during feasibility restoration.
        """
        from ..dynamics import integrators as igs
        from ..dynamics.rollouts import open_rollout, rollout, unitary_rollout
        from ..trajectory.named_trajectory import derivative as _derivative

        rng = rng or np.random.default_rng(0)
        traj = self.trajectory
        T = traj.T
        z0 = np.asarray(self.initial_decision(1))[0]
        dts = np.asarray(traj.get_timesteps(), dtype=np.float64)
        a_sl = traj.comp_slice(self.control_name)

        # all perturbed control banks at once (seed 0 stays clean)
        rows = np.broadcast_to(z0, (n_seeds, *z0.shape)).copy()
        a_all = np.array(rows[:, :, a_sl], dtype=np.float64)
        a_all[1:, 1:-1] += sigma * rng.standard_normal(
            a_all[1:, 1:-1].shape
        )
        if self.control_name in traj.bounds:
            lo, hi = traj.bounds[self.control_name]
            a_all = np.clip(a_all, lo[None, None, :], hi[None, None, :])
        rows[:, :, a_sl] = a_all

        # derivative chains (x -> dx defects); host numpy, batched over seeds
        for ig in self.integrators:
            if isinstance(ig, igs.DerivativeIntegrator):
                x_sl = traj.comp_slice(ig.x_name)
                dx_sl = traj.comp_slice(ig.dx_name)
                x = rows[:, :, x_sl]
                diff = (x[:, 1:] - x[:, :-1]) / dts[None, : T - 1, None]
                rows[:, :, dx_sl] = np.concatenate(
                    [diff, diff[:, -1:]], axis=1
                )

        # dynamics states rolled out under the perturbed controls — ONE
        # jitted vmapped device call per integrator (not a per-seed Python
        # loop of device calls)
        a_j = jnp.asarray(a_all)
        for ig in self.integrators:
            if isinstance(
                ig,
                (igs.UnitaryExponentialIntegrator, igs.UnitaryPadeIntegrator),
            ):
                roll, s_sl = unitary_rollout, traj.comp_slice(ig.state_name)
            elif isinstance(
                ig,
                (
                    igs.QuantumStateExponentialIntegrator,
                    igs.QuantumStatePadeIntegrator,
                ),
            ):
                roll, s_sl = rollout, traj.comp_slice(ig.state_name)
            elif isinstance(ig, igs.DensityOperatorExponentialIntegrator):
                roll, s_sl = open_rollout, traj.comp_slice(ig.state_name)
            else:
                continue
            v0 = jnp.asarray(rows[0, 0, s_sl])
            batched = jax.jit(
                jax.vmap(lambda a: roll(v0, a, jnp.asarray(dts), ig.system))
            )
            rows[:, :, s_sl] = np.asarray(batched(a_j))
        return rows

    def solve_multistart(
        self,
        n_seeds: int = 8,
        *,
        sigma: float = 0.1,
        rng=None,
        max_iter: int | None = None,
        segment_iters: int | None = None,
    ):
        """Batched multi-start solve: diverse rollout-consistent seeds
        advance in lockstep; the best (lowest objective) is kept.

        This is the batched answer to nonconvexity — a batch of seeds
        costs barely more than one solve on accelerator hardware.
        """
        Z0 = self.multistart_initial_decisions(n_seeds, sigma=sigma, rng=rng)
        res = self.solver.solve(
            jnp.asarray(Z0), max_iter=max_iter, segment_iters=segment_iters
        )
        self.result = res
        # prefer converged seeds; break ties by objective
        obj = np.asarray(res.objective)
        conv = np.asarray(res.converged)
        score = np.where(conv, obj, obj + 1e10)
        best = int(np.argmin(score))
        self.trajectory = self.write_back(np.asarray(res.Z[best]))
        if self.ipopt_options.print_level >= 3:
            print(
                f"[qct] multistart best seed {best}: converged={bool(conv[best])} "
                f"obj={float(obj[best]):.6e} ({int(conv.sum())}/{n_seeds} converged)"
            )
        return self

    # ---- reference API parity ---- #
    def get_objective(self) -> Objective:
        return self.objective

    def get_constraints(self):
        return list(self.constraints)
