"""Solver and framework option structs.

SolverOptions mirrors the reference's IpoptOptions surface (call sites:
/root/reference/src/problem_templates/unitary_bang_bang_problem.jl:207,
unitary_sampling_problem.jl:216) for the in-house interior-point method;
PiccoloOptions mirrors the framework-level flag struct (field inventory:
SURVEY.md §2b, uses at _problem_templates.jl:41-73).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["SolverOptions", "IpoptOptions", "PiccoloOptions"]


@dataclasses.dataclass
class SolverOptions:
    """Options for the batched primal-dual interior-point solver."""

    print_level: int = 1
    max_iter: int = 100
    tol: float = 1e-8
    # Ipopt's acceptable-level termination (options `acceptable_tol` /
    # `acceptable_iter`): declare success when the scaled optimality error
    # stays <= acceptable_tol for acceptable_iter CONSECUTIVE iterations.
    # This is how Ipopt handles quasi-Newton tails whose dual infeasibility
    # floors above `tol` (hessian_approximation=limited-memory).  Ipopt
    # defaults: 1e-6 / 15.  acceptable_iter=0 disables.
    acceptable_tol: float = 1e-6
    acceptable_iter: int = 15
    # barrier schedule (Fiacco-McCormick, Ipopt defaults)
    mu_init: float = 1e-1
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_epsilon: float = 10.0
    tau_min: float = 0.99
    # barrier strategy: "monotone" (Fiacco-McCormick, the fields above) or
    # "adaptive" (LOQO centrality oracle — Ipopt's mu_strategy=adaptive,
    # mu_oracle=loqo analog; re-centers every iteration, no extra solves)
    mu_strategy: str = "monotone"
    mu_max: float = 1e2
    # regularization
    delta_w_init: float = 1e-8
    delta_w_min: float = 1e-20
    delta_w_max: float = 1e6
    delta_c: float = 1e-8
    # rho*J^T J inertia lift: the stage-wise Riccati factorization needs
    # every partially-condensed block PD — a condition that can demand
    # delta_w 100-1000x larger than the true reduced-Hessian negative
    # curvature (measured on free-dt min-time: lambda_min(reduced) = -0.46
    # but plain factorization needs delta_w >= 100, crippling Newton into a
    # crawl).  Adding rho*J^T J to the (1,1) block is an EXACT transform
    # (J dz = rnu on the solution manifold => same (dz, nu)), preserves the
    # block-tridiagonal structure, and makes the stage-PD condition track
    # the true reduced inertia, so delta_w ~ |lambda_min| suffices.  Engaged
    # only from the `kkt_aug_start`-th factorization retry (the plain fast
    # path is unchanged); rho = kkt_aug_rho_factor * max_t ||H_t||_inf per
    # instance.  kkt_aug_start=1 engages the lift on EVERY regularized
    # retry (k=0 stays plain): a plain attempt at the warm-started large
    # delta would otherwise succeed first and mask the small-delta
    # augmented direction (measured: min-time stayed at delta_w ~ 100-800
    # with kkt_aug_start=2 because plain k=1 succeeded).
    # Default "auto" = on iff the NLP carries stage inequality rows
    # (min-time fidelity floors, L1 slacks, modulus disks) — the class
    # where the persistent-negative-curvature crawl occurs.  Measured A/B
    # (CPU f32, B=64, 44 iters): min_time success 0.906 -> 0.953 with the
    # lift, while always-on cost the PLAIN hadamard path 80% wall and
    # 0.98 -> 0.89 converged (f32 conditioning noise from rho) — hence not
    # a blanket default.  True/False force.
    kkt_aug: Any = "auto"
    kkt_aug_rho_factor: float = 2.0
    kkt_aug_start: int = 1
    # retry warm start: skip the known-doomed plain (dw=0, rho=0) first
    # factorization attempt for instances whose PREVIOUS iteration needed
    # regularization — their k=0 attempt starts directly at dw_prev/3 with
    # the rho lift engaged (per instance; cold instances still try pure
    # Newton first).  Measured on the min-time class the plain attempt
    # fails for ~100% of instances on ~100% of iterations (round-5 diag),
    # so every iteration paid >= 1 wasted batched factorization.  The
    # /3-per-success decay still recovers the Newton tail: once
    # dw_prev/3 < kkt_retry_warm_min the instance resumes trying dw=0.
    # "auto" = on iff the rho*J^T J lift is active (the chronic-retry
    # class); True/False force.
    kkt_retry_warm: Any = "auto"
    kkt_retry_warm_min: float = 1e-6
    # feasibility restoration (the batched analog of Ipopt algorithm A-9,
    # the one structural Ipopt piece the reference inherits that rounds
    # 1-4 lacked): when an instance's line search fails `resto_trigger`
    # consecutive iterations while still infeasible, the instance enters a
    # restoration episode — its objective model is swapped for the scaled
    # proximity cost zeta/2 ||D_R (z - z_R)||^2 (D_R = min(1, 1/|z_R|),
    # Ipopt's scaling) while the linearized defects/bounds/barrier
    # machinery keeps running, so each step is a proximal Newton projection
    # toward the feasible manifold through the SAME batched KKT solve (no
    # second solver).  Unlike Ipopt we keep hard linearized defect rows
    # instead of the l1-elastic split (p, n slacks): the delta_c
    # regularization plays the elastic role and no NLP resizing is needed
    # in lockstep batch mode.  The episode ends when the l1 infeasibility
    # theta drops below resto_kappa * theta_entry (or tol, or after
    # resto_max_iters), the instance's filter is reset on entry and exit,
    # and equality multipliers are frozen across the episode.  Exact /
    # Gauss-Newton Hessian modes only (L-BFGS's sigma*I model never
    # produces the degenerate steps restoration exists for).
    restoration: bool = True
    # trigger 8 (not 4): trigger=4 was measured entering episodes on
    # transiently-rejected but CONVERGING instances (B=512 Hadamard,
    # converged_frac 0.912 -> 0.881); trigger=8 restores 0.908 while still
    # catching genuine stalls (the manufactured-stall tests pass unchanged)
    resto_trigger: int = 8
    # extra iterative-refinement passes after every KKT solve, re-solving
    # the f32 residual through the SAME kept factorization (triangular
    # work only).  Each pass multiplies the backward error by ~eps*cond.
    # Implies factor-keeping on the xla/triton backends (like soc).
    kkt_refine: int = 0
    resto_kappa: float = 0.1
    resto_zeta: float = 1e-3
    resto_max_iters: int = 10
    # line search: "filter" (Wächter–Biegler filter acceptance: a trial is
    # accepted when it improves constraint violation OR barrier objective
    # vs. the filter, with an Armijo test on the barrier objective when the
    # switching condition holds — Ipopt's globalization) or "merit"
    # (l1-merit backtracking with best-merit fallback)
    line_search: str = "merit"
    max_ls_iters: int = 10
    # Armijo slope fraction eta_phi in the filter f-type acceptance test
    # phi(trial) <= phi + eta * alpha * grad_phi^T dz (Ipopt eta_phi)
    armijo_eta: float = 1e-4
    # filter parameters (Wächter & Biegler 2006, Table 1 defaults)
    theta_max_fact: float = 1e4  # absolute-infeasibility cap factor
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    s_theta: float = 1.1
    s_phi: float = 2.3
    delta_ls: float = 1.0
    filter_size: int = 8  # device-resident filter slots (oldest evicted)
    # watchdog: accept up to `watchdog_trials` non-monotone full steps before
    # falling back to the last safe iterate (0 disables)
    watchdog_trials: int = 0
    # second-order correction (Ipopt step A-5.1): when the full step is
    # rejected and constraint violation grew, re-solve the SAME KKT
    # factorization with a corrected defect rhs and take that step if it
    # wins on merit.  Reuses the factorization (triangular solves only; on
    # the triton backend, the rhs-only kernel sweeps).  Supported by the
    # exact/Gauss-Newton Hessian modes on the "xla" and "triton" backends;
    # inert on "cr" (keeps no factors) and with quasi_newton="lbfgs" (the
    # SMW-corrected factorization is not kept — enable soc with
    # gauss-newton instead).
    soc: bool = False
    kappa_soc: float = 0.99
    # dual recalculation (least-squares multiplier resets; the reference's
    # recalc_y knob, unitary_robustness_problem.jl:166 — Ipopt spells it
    # "yes"/"no", accepted here alongside bools)
    recalc_y: bool = False
    recalc_y_feas_tol: float = 1e-6
    # quasi-Newton mode used when the problem requests eval_hessian=False:
    # "lbfgs" (compact limited-memory BFGS + SMW low-rank KKT correction —
    # Ipopt's hessian_approximation=limited-memory analog) or "gauss-newton"
    # (drop defect curvature, keep exact cost Hessians)
    quasi_newton: str = "lbfgs"
    lbfgs_memory: int = 6
    # numerical type for solver state: None -> follow the input dtype;
    # "float32"/"float64" force a cast of the initial decision (f64 needs
    # jax_enable_x64, i.e. the CPU/test backend)
    dtype: str | None = None
    # matmul precision for solver arithmetic (jax.default_matmul_precision):
    # "highest" (full f32), "high" or "default" (reduced-precision products,
    # e.g. TF32 on the GPU — insufficient for tight KKT tolerances)
    matmul_precision: str = "highest"
    # precision ladder: NLP function/derivative evaluation (defects,
    # Jacobians, Hessians, merit) may run at a lower pass count than the KKT
    # factorization; None -> follow matmul_precision
    eval_precision: str | None = None
    # Ipopt-style gradient-based objective/constraint scaling plus
    # Jacobian-column variable scaling, computed once at the initial point
    nlp_scaling: bool = True
    # KKT factorization backend: "xla" (vmapped Riccati scan over knots),
    # "triton" (fused Pallas kernels on the GPU's Triton route: one program
    # per instance walks every knot; stage dims up to 64), "cr" (block
    # cyclic reduction, parallel-in-T: O(log T) critical path — the latency
    # backend for single/small-batch solves; soc is inert on "cr", which
    # keeps no reusable factors), or "auto" (resolved once per solver by
    # InteriorPointSolver: see resolve_kkt_backend)
    kkt_backend: str = "auto"
    # run the triton backend's kernels in the Pallas interpreter (CPU
    # tests); never implied by the platform
    kkt_interpret: bool = False

    _ENUMS = {
        "mu_strategy": ("monotone", "adaptive"),
        "quasi_newton": ("lbfgs", "gauss-newton"),
        "kkt_backend": ("auto", "xla", "triton", "cr"),
        "matmul_precision": ("default", "high", "highest"),
        "eval_precision": (None, "default", "high", "highest"),
        "dtype": (None, "float32", "float64"),
        "line_search": ("filter", "merit"),
    }

    def __post_init__(self):
        import os

        if isinstance(self.recalc_y, str):
            self.recalc_y = self.recalc_y.lower() in ("yes", "true", "on")
        # experiment escape hatch: QCT_KKT_AUG=0 disables the rho*J^T J
        # lift globally (A/B benchmarking without code changes)
        if "QCT_KKT_AUG" in os.environ:
            v = os.environ["QCT_KKT_AUG"]
            self.kkt_aug = (
                "auto" if v == "auto" else v not in ("0", "false")
            )
        if self.kkt_aug not in (True, False, "auto"):
            raise ValueError(
                f"SolverOptions.kkt_aug={self.kkt_aug!r} must be True, "
                f"False, or 'auto'"
            )
        for field, allowed in self._ENUMS.items():
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(
                    f"SolverOptions.{field}={val!r} is not one of {allowed}"
                )

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


# Back-compatible alias: templates accept ipopt_options=...
IpoptOptions = SolverOptions


@dataclasses.dataclass
class PiccoloOptions:
    """Framework-level flags threaded through every problem template."""

    verbose: bool = True
    free_time: bool = True
    timesteps_all_equal: bool = True
    integrator: str = "pade"  # or "exponential"
    pade_order: int = 4
    # integrator used by initialization/validation rollouts: "expm" (dense
    # propagator bank, parallel-in-t) or "expv" (Krylov/Taylor action of
    # exp(G dt) on the state without forming the propagator — the
    # reference's default, /root/reference/src/trajectory_initialization.jl:398)
    rollout_integrator: str = "expm"
    geodesic: bool = True
    bound_state: bool = False
    eval_hessian: bool = True
    leakage_suppression: bool = False
    R_leakage: float = 1.0
    complex_control_norm_constraint_name: str | None = None
    complex_control_norm_constraint_radius: float = 1.0
    build_trajectory_constraints: bool = True
    # exploit defect sparsity structure: nonlinear-coordinate-restricted
    # Hessian passes + (where available) the analytic propagator-bank
    # assembly.  False falls back to dense AD over full knot rows.
    jacobian_structure: bool = True

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)
