"""Batched primal-dual interior-point method over stage-structured NLPs.

Replaces Ipopt (the reference's L1 native component, /root/reference/README.md:93)
with an in-house IPM designed for batched accelerator execution:

- ALL state is shaped (batch, ...) — thousands of independent gate-synthesis
  instances / multi-start seeds advance in lockstep, with per-instance
  convergence masks (converged instances freeze).
- The Newton/KKT step is the block-tridiagonal stage-wise factorization in
  kkt.py (lax.scan over knots, vmapped over the batch).
- Barrier schedule follows Fiacco-McCormick with Ipopt's default parameters
  (kappa_mu=0.2, theta_mu=1.5); fraction-to-boundary with tau = max(tau_min,
  1-mu); backtracking line search on an l1 merit function; adaptive primal
  regularization delta_w with factorization-failure retries (the inertia
  correction analog).

Inequalities g(z) >= 0 are handled with slacks sigma and duals w; bounds with
duals zl, zu; both are condensed into the stage Hessian (primal-dual Sigma
terms) so the KKT system stays block-tridiagonal.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .kkt import KKTFactors, factor_kkt, solve_kkt, solve_with_factors
from .kkt_cr import solve_kkt_cr
from .kkt_triton import (
    MAX_TILE,
    TritonFactors,
    resolve_kkt_triton,
    solve_kkt_triton,
    tile_dim,
)
from .lbfgs import lbfgs_compact, lbfgs_update
from .options import SolverOptions
from .stage_nlp import StageNLP, make_nlp_functions

__all__ = [
    "IPMState", "IPMResult", "InteriorPointSolver", "resolve_kkt_backend",
]

_BIG = 1e20


class IPMState(NamedTuple):
    Z: Any  # (B, T, d)
    lam: Any  # (B, T-1, s)
    sig: Any  # (B, T, m)
    w: Any  # (B, T, m)
    zl: Any  # (B, T, d)
    zu: Any  # (B, T, d)
    mu: Any  # (B,)
    delta_w: Any  # (B,)
    converged: Any  # (B,) bool
    n_iter: Any  # (B,) int32
    kkt_err: Any  # (B,)
    # telemetry (per iteration)
    alpha: Any = 0.0  # (B,) accepted primal step size
    e_dual: Any = 0.0  # (B,)
    e_pr: Any = 0.0  # (B,)
    e_comp: Any = 0.0  # (B,)
    ls_k: Any = 0  # (B,) line-search backtracks used
    reg_dw: Any = 0.0  # (B,) delta_w used in the accepted factorization
    alpha_du: Any = 0.0  # (B,) accepted dual (bound-multiplier) step size
    d_norm: Any = 0.0  # (B,) sup-norm of the accepted primal step
    # Wächter–Biegler filter state (None unless line_search == "filter"):
    flt_theta: Any = None  # (B, Fs) filter infeasibility entries (+inf = empty)
    flt_phi: Any = None  # (B, Fs) filter barrier-objective entries
    flt_ptr: Any = None  # (B,) int32 ring pointer (oldest slot evicted)
    theta_ref: Any = None  # (B,) max(1, theta_0) scale for theta_min/max
    # limited-memory BFGS state (None unless quasi_newton == "lbfgs"):
    qn_S: Any = None  # (B, mem, T*d) step history (chronological)
    qn_Y: Any = None  # (B, mem, T*d) Lagrangian-gradient differences
    qn_sty: Any = None  # (B, mem) curvature products s_i^T y_i
    qn_count: Any = None  # (B,) int32 valid pairs
    qn_prevZ: Any = None  # (B, T, d) previous primal iterate
    qn_sigma: Any = None  # (B,) B0 = sigma*I scaling
    # consecutive iterations with E0 <= acceptable_tol (Ipopt acceptable-
    # level termination); int32 (B,)
    acc_count: Any = 0
    # feasibility-restoration state (None unless SolverOptions.restoration
    # with an exact/Gauss-Newton Hessian; Ipopt A-9 analog):
    ls_fail: Any = None  # (B,) bool: last line search fell back
    stall_count: Any = None  # (B,) int32 consecutive ls failures
    in_resto: Any = None  # (B,) bool: instance is in a restoration episode
    resto_zR: Any = None  # (B, T, d) proximity reference iterate
    resto_theta0: Any = None  # (B,) l1 infeasibility at episode entry
    resto_k: Any = None  # (B,) int32 iterations inside the episode
    # watchdog state (None unless watchdog_trials > 0 with the filter line
    # search): when the filter rejects every trial step, up to
    # watchdog_trials FULL steps are taken tentatively; if no acceptable
    # point appears, the iterate is rewound to the snapshot (Ipopt's
    # non-monotone watchdog heuristic)
    wd_count: Any = None  # (B,) int32 tentative steps taken (0 = inactive)
    wd_cool: Any = None  # (B,) int32 re-activation cooldown after a rewind
    wd_Z: Any = None  # (B, T, d) snapshot primal
    wd_lam: Any = None  # (B, T-1, s)
    wd_sig: Any = None  # (B, T, m)
    wd_w: Any = None  # (B, T, m)
    wd_zl: Any = None  # (B, T, d)
    wd_zu: Any = None  # (B, T, d)


class IPMResult(NamedTuple):
    Z: Any
    lam: Any
    converged: Any
    n_iter: Any
    kkt_err: Any
    mu: Any
    objective: Any


class _KKTIn(NamedTuple):
    H: Any
    C: Any
    A: Any
    B: Any
    rz: Any
    rnu: Any
    # compact L-BFGS low-rank correction (None in exact/GN modes):
    # the KKT zz-block is H_base - U M^{-1} U^T, applied by SMW
    U: Any = None  # (T*d, 2*mem)
    M: Any = None  # (2*mem, 2*mem)
    # rho*J^T J lift scale, computed from the PRE-BARRIER Lagrangian
    # Hessian (the barrier Sigma terms are PSD and explode as slacks -> 0;
    # including them was measured to push rho to ~4e10 near convergence,
    # drowning the recovered multipliers in conditioning noise)
    rho0: Any = 0.0  # scalar per instance


class _IterAux(NamedTuple):
    F: Any
    g: Any
    Jg: Any
    mu: Any
    tau: Any
    sl: Any
    su: Any
    Sig_l: Any
    Sig_u: Any
    E0: Any
    E_dual: Any
    E_pr: Any
    E_comp0: Any
    now_converged: Any
    lam: Any  # effective equality multipliers (post-recalc_y reset)
    rz_kkt: Any  # the KKT z-row rhs (for second-order-correction re-solves)
    gcost: Any = None  # cost gradient (filter line search directional deriv)
    mu_changed: Any = False  # barrier parameter updated -> filter reset
    # updated L-BFGS memory (written back to the state by _iteration_post)
    qn_S: Any = None
    qn_Y: Any = None
    qn_sty: Any = None
    qn_count: Any = None
    qn_sigma: Any = None
    # restoration transitions decided in _iteration_pre (persisted by post)
    in_resto: Any = None
    resto_zR: Any = None
    stall_count: Any = None
    resto_theta0: Any = None
    resto_k: Any = None


# largest stage tile on which the triton kernels beat the XLA scan end to
# end (H100, PERF.md): 14.7x per IPM iteration at d=15 (tile 16),
# 10x at d=28 (tile 32), 1.6x SLOWER at d=47 (tile 64)
AUTO_MAX_TILE = 32


def resolve_kkt_backend(options: SolverOptions, d: int, s: int) -> str:
    """The one backend-dispatch policy: SolverOptions.kkt_backend ->
    the concrete backend a solver runs, decided once per solver.

    "auto" takes the triton kernels on a GPU when the stage tile is at most
    AUTO_MAX_TILE, else the XLA scan.  An explicit "triton" that cannot
    compile for this platform raises instead of silently running
    elsewhere; its interpreter runs only when kkt_interpret asks for it."""
    backend = options.kkt_backend
    tile = tile_dim(max(d, s))
    on_gpu = jax.default_backend() == "gpu"
    if backend == "auto":
        return "triton" if (on_gpu and tile <= AUTO_MAX_TILE) else "xla"
    fits = tile <= MAX_TILE
    if backend == "triton":
        if not fits:
            raise ValueError(
                f"kkt_backend='triton' supports stage dims up to {MAX_TILE} "
                f"(got d={d}, s={s}); use 'xla' or 'auto'"
            )
        if not (on_gpu or options.kkt_interpret):
            raise ValueError(
                "kkt_backend='triton' compiles for a CUDA GPU only (default "
                f"backend is {jax.default_backend()!r}); pass "
                "kkt_interpret=True to run the kernels in the Pallas "
                "interpreter"
            )
    return backend


@dataclasses.dataclass(eq=False)  # identity hash: jit-static self
class InteriorPointSolver:
    """Compiled IPM for one StageNLP structure (batched over instances)."""

    nlp: StageNLP
    options: SolverOptions = dataclasses.field(default_factory=SolverOptions)
    exact_hessian: bool = True

    def __post_init__(self):
        self.options = self.options.replace(
            kkt_backend=resolve_kkt_backend(
                self.options, self.nlp.d, self.nlp.s
            )
        )
        self.qn_lbfgs = (
            not self.exact_hessian and self.options.quasi_newton == "lbfgs"
        )
        # resolve the rho*J^T J lift: "auto" = on iff the NLP carries stage
        # inequality rows (the persistent-negative-curvature class:
        # fidelity floors, L1 slacks, modulus disks); L-BFGS mode never
        # needs it (sigma*I base Hessian is PD)
        self.kkt_aug_on = (
            (self.nlp.m > 0 if self.options.kkt_aug == "auto"
             else bool(self.options.kkt_aug))
            and not self.qn_lbfgs
        )
        # retry warm start (SolverOptions.kkt_retry_warm): "auto" follows
        # the lift — the chronic-retry class where the plain first attempt
        # fails ~always (round-5 min-time diag: dw>0 for ~100% of instances
        # on every iteration => one wasted batched factorization/iter)
        self.retry_warm_on = (
            self.kkt_aug_on
            if self.options.kkt_retry_warm == "auto"
            else bool(self.options.kkt_retry_warm)
        )
        # feasibility restoration (Ipopt A-9 analog; SolverOptions docs):
        # exact/GN Hessian modes only
        self.resto_on = bool(self.options.restoration) and not self.qn_lbfgs
        self.kkt_refine_n = int(self.options.kkt_refine)
        if self.options.soc and (
            self.options.kkt_backend == "cr" or self.qn_lbfgs
        ):
            # one-time signal (instead of silent inertness): these paths
            # keep no reusable factorization, so A-5.1 re-solves can't run
            print(
                "[qct] note: soc=True is inert with "
                f"kkt_backend={self.options.kkt_backend!r}"
                + (" + quasi_newton='lbfgs'" if self.qn_lbfgs else "")
                + " (no reusable KKT factors); steps fall back to the "
                "plain filter/merit line search"
            )
        nlp_raw = self.nlp
        self.var_scale = np.ones(nlp_raw.d)
        self.obj_scale = 1.0
        if self.options.nlp_scaling:
            self.nlp = self._build_scaled_nlp(nlp_raw)
        self.funcs = make_nlp_functions(
            self.nlp, exact_hessian=self.exact_hessian
        )
        nlp = self.nlp
        # static masks (host numpy -> constants)
        self._free = np.asarray(nlp.free_mask, dtype=np.float64)
        lb = np.asarray(nlp.lb, dtype=np.float64)
        ub = np.asarray(nlp.ub, dtype=np.float64)
        self._has_lb = (np.isfinite(lb) & (self._free > 0)).astype(np.float64)
        self._has_ub = (np.isfinite(ub) & (self._free > 0)).astype(np.float64)
        self._lb = np.where(np.isfinite(lb), lb, -_BIG)
        self._ub = np.where(np.isfinite(ub), ub, _BIG)

    def _build_scaled_nlp(self, nlp: StageNLP) -> StageNLP:
        """Ipopt-style gradient-based scaling + Jacobian-column variable
        scaling, computed numerically once at the initial point.

        Variable scale v_j = 1/max(1, max-col-norm of the defect Jacobian)
        equalizes curvature (stiff Δt columns with ||∂F/∂Δt|| ~ ||G|| get
        shrunk); row scales keep each scaled defect/inequality row and the
        objective gradient at O(1..100).
        """
        from .stage_nlp import make_nlp_functions as _mk, scale_stage_nlp

        funcs0 = _mk(nlp, exact_hessian=False)
        z0 = jnp.asarray(nlp.z0, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        with jax.default_matmul_precision(self.options.matmul_precision):
            A, B, Jg = jax.jit(funcs0.jac_blocks)(z0)
            gphi = jax.jit(
                lambda z: funcs0.grad_lagrangian(
                    z,
                    jnp.zeros((nlp.T - 1, nlp.s), z.dtype),
                    jnp.zeros((nlp.T, nlp.m), z.dtype),
                )
            )(z0)
        A = np.abs(np.asarray(A))
        B = np.abs(np.asarray(B))
        free = np.asarray(nlp.free_mask, dtype=np.float64)
        # column norms over all knots and defect rows (free columns only)
        col = np.maximum(A.max(axis=(0, 1)), B.max(axis=(0, 1)))
        col = col * (free.max(axis=0) > 0)
        v = 1.0 / np.maximum(1.0, col)
        # scaled row norms -> defect row scales
        rowA = (A * v[None, None, :]).max(axis=(0, 2))
        rowB = (B * v[None, None, :]).max(axis=(0, 2))
        r = 1.0 / np.maximum(1.0, np.maximum(rowA, rowB))
        # inequality row scales
        if nlp.m > 0:
            Jg = np.abs(np.asarray(Jg))
            q = 1.0 / np.maximum(
                1.0, (Jg * v[None, None, :]).max(axis=(0, 2))
            )
        else:
            q = np.ones(0)
        # objective gradient scale (Ipopt: scale down if > 100)
        gmax = float(np.max(np.abs(np.asarray(gphi)) * v[None, :]))
        s_obj = 100.0 / max(100.0, gmax)
        self.var_scale = v
        self.obj_scale = s_obj
        return scale_stage_nlp(nlp, v, r, q, s_obj)

    def unscale(self, Z):
        """Map solver-internal (scaled) decision values back to problem units."""
        return np.asarray(Z) * self.var_scale

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #
    def init_state(self, Z0):
        """Z0: (B, T, d) initial primal values in PROBLEM units (batch
        required); internally converted to scaled coordinates."""
        opts = self.options
        nlp = self.nlp
        Z0 = jnp.asarray(Z0)
        if opts.dtype is not None:
            Z0 = Z0.astype(jnp.dtype(opts.dtype))
        if self.options.nlp_scaling:
            Z0 = Z0 / jnp.asarray(self.var_scale, Z0.dtype)
        assert Z0.ndim == 3, "Z0 must be (batch, T, d)"
        B = Z0.shape[0]
        dtype = Z0.dtype
        lb = jnp.asarray(self._lb, dtype)
        ub = jnp.asarray(self._ub, dtype)
        has_lb = jnp.asarray(self._has_lb, dtype)
        has_ub = jnp.asarray(self._has_ub, dtype)

        # push strictly inside bounds (Ipopt kappa_1 = 1e-2 interior push)
        width = jnp.where((has_lb * has_ub) > 0, ub - lb, 1.0)
        pert = 1e-2 * jnp.minimum(
            jnp.maximum(1.0, jnp.abs(lb)), width
        )
        pert_u = 1e-2 * jnp.minimum(jnp.maximum(1.0, jnp.abs(ub)), width)
        zlo = jnp.where(has_lb > 0, lb + pert, -_BIG)
        zhi = jnp.where(has_ub > 0, ub - pert_u, _BIG)
        free = jnp.asarray(self._free, dtype)
        Z = jnp.where(free > 0, jnp.clip(Z0, zlo, zhi), Z0)

        mu0 = jnp.full((B,), opts.mu_init, dtype)
        g0 = jax.vmap(self.funcs.ineqs)(Z)
        sig = jnp.maximum(g0, 1e-2)
        # m == 0: w must be a DISTINCT (empty) buffer — an aliased leaf
        # breaks _solve_loop's whole-state donation (donate-twice error on
        # the eager segment path)
        w = mu0[:, None, None] / sig if nlp.m > 0 else jnp.zeros_like(sig)
        zl = jnp.broadcast_to(has_lb, Z.shape) * 1.0
        zu = jnp.broadcast_to(has_ub, Z.shape) * 1.0

        # least-squares initial multipliers (Ipopt's default dual init):
        # solve the saddle system with H = I, C = 0 — lam_LS = nu minimizes
        # ||grad phi - J^T lam||; discard if absurdly large.
        def ls_lam(Zi, wi):
            A, Bj, _ = self.funcs.jac_blocks(Zi)
            free_c = jnp.asarray(self._free, dtype)
            A = A * free_c[:-1, None, :]
            Bj = Bj * free_c[1:, None, :]
            gphi = self.funcs.grad_lagrangian(
                Zi, jnp.zeros((nlp.T - 1, nlp.s), dtype), wi
            ) * free_c
            eye = jnp.broadcast_to(
                jnp.eye(nlp.d, dtype=dtype), (nlp.T, nlp.d, nlp.d)
            )
            Cz = jnp.zeros((nlp.T - 1, nlp.d, nlp.d), dtype)
            _, nu, ok = solve_kkt(
                eye, Cz, A, Bj, gphi, jnp.zeros((nlp.T - 1, nlp.s), dtype),
                1e-8,
            )
            lam = jnp.where(ok, nu, 0.0)
            too_big = jnp.max(jnp.abs(lam)) > 1e3
            return jnp.where(too_big, jnp.zeros_like(lam), lam)

        with jax.default_matmul_precision(self.options.matmul_precision):
            lam0 = jax.vmap(ls_lam)(Z, w)

        # every leaf gets its OWN buffer: _solve_loop donates the whole
        # state, and any two aliased leaves trip XLA's donate-twice check
        # on the eager segment path (init_state outside jit)
        def zeros():
            return jnp.zeros((B,), dtype)

        if self.options.line_search == "filter":
            # initial infeasibility sets the filter scales (Ipopt:
            # theta_min = 1e-4 max(1, theta_0), theta_max = 1e4 max(1, theta_0))
            F0 = jax.vmap(self.funcs.defects)(Z)
            theta0 = jnp.sum(jnp.abs(F0), axis=(1, 2))
            if nlp.m > 0:
                theta0 = theta0 + jnp.sum(jnp.abs(g0 - sig), axis=(1, 2))
            Fs = self.options.filter_size
            flt = dict(
                flt_theta=jnp.full((B, Fs), jnp.inf, dtype),
                flt_phi=jnp.full((B, Fs), jnp.inf, dtype),
                flt_ptr=jnp.zeros((B,), jnp.int32),
                theta_ref=jnp.maximum(1.0, theta0),
            )
        else:
            flt = {}
        if opts.watchdog_trials > 0 and opts.line_search == "filter":
            wd = dict(
                wd_count=jnp.zeros((B,), jnp.int32),
                wd_cool=jnp.zeros((B,), jnp.int32),
                # copies, not aliases: whole-state donation (see zeros())
                wd_Z=Z + jnp.zeros_like(Z),
                wd_lam=lam0 + jnp.zeros_like(lam0),
                wd_sig=sig + jnp.zeros_like(sig),
                wd_w=w + jnp.zeros_like(w),
                wd_zl=zl + jnp.zeros_like(zl),
                wd_zu=zu + jnp.zeros_like(zu),
            )
        else:
            wd = {}
        if self.qn_lbfgs:
            mem = self.options.lbfgs_memory
            n = nlp.T * nlp.d
            qn = dict(
                qn_S=jnp.zeros((B, mem, n), dtype),
                qn_Y=jnp.zeros((B, mem, n), dtype),
                qn_sty=jnp.zeros((B, mem), dtype),
                qn_count=jnp.zeros((B,), jnp.int32),
                qn_prevZ=Z + jnp.zeros_like(Z),  # s=0 pair skipped; copy
                qn_sigma=jnp.ones((B,), dtype),
            )
        else:
            qn = {}
        if self.resto_on:
            resto = dict(
                ls_fail=jnp.zeros((B,), bool),
                stall_count=jnp.zeros((B,), jnp.int32),
                in_resto=jnp.zeros((B,), bool),
                # distinct buffer: _solve_loop donates the state, and an
                # aliased leaf would be donated twice
                resto_zR=Z + jnp.zeros_like(Z),
                resto_theta0=jnp.zeros((B,), dtype),
                resto_k=jnp.zeros((B,), jnp.int32),
            )
        else:
            resto = {}
        return IPMState(
            Z=Z,
            lam=lam0,
            sig=sig,
            w=w,
            zl=zl,
            zu=zu,
            mu=mu0,
            delta_w=jnp.zeros((B,), dtype),
            converged=jnp.zeros((B,), bool),
            n_iter=jnp.zeros((B,), jnp.int32),
            kkt_err=jnp.full((B,), jnp.inf, dtype),
            alpha=zeros(),
            e_dual=zeros(),
            e_pr=zeros(),
            e_comp=zeros(),
            ls_k=jnp.zeros((B,), jnp.int32),
            reg_dw=zeros(),
            alpha_du=zeros(),
            d_norm=zeros(),
            acc_count=jnp.zeros((B,), jnp.int32),
            **flt,
            **wd,
            **qn,
            **resto,
        )

    # ------------------------------------------------------------------ #
    # single-instance iteration pieces (vmapped over the batch by `step`;
    # the batched KKT solve happens between pre and post, outside the vmap,
    # so the kernel backend operates on the whole batch)
    # ------------------------------------------------------------------ #
    def _iteration_pre(self, state: IPMState):
        opts = self.options
        nlp = self.nlp
        f = self.funcs
        T, d, s, m = nlp.T, nlp.d, nlp.s, nlp.m
        Z = state.Z
        lam, sig, w = state.lam, state.sig, state.w
        zl, zu = state.zl, state.zu
        mu = state.mu
        dtype = Z.dtype

        free = jnp.asarray(self._free, dtype)
        has_lb = jnp.asarray(self._has_lb, dtype)
        has_ub = jnp.asarray(self._has_ub, dtype)
        lb = jnp.asarray(self._lb, dtype)
        ub = jnp.asarray(self._ub, dtype)

        # slacks carry a dtype-aware floor: a primal step can land EXACTLY
        # on a bound in floating point (observed: adaptive-mu min-time run,
        # Z - lb == 0 at iter 85 -> mu/sl = inf -> NaN duals).  The floor
        # keeps every 1/sl, mu/sl, z/sl finite; fraction-to-boundary still
        # governs the actual step sizes.
        tiny = 1e-100 if Z.dtype == jnp.float64 else 1e-30
        sl = jnp.where(has_lb > 0, jnp.maximum(Z - lb, tiny), 1.0)
        su = jnp.where(has_ub > 0, jnp.maximum(ub - Z, tiny), 1.0)

        # ---------------- residuals & KKT error ---------------- #
        # precision ladder: function/derivative evaluation may run at a
        # lower matmul precision than the factorization
        eval_prec = opts.eval_precision or opts.matmul_precision
        with jax.default_matmul_precision(eval_prec):
            # ONE fused dynamics pass: defects + Jacobian blocks (+ the
            # propagator-bank aux reused by the Hessian below)
            F, A, Bj, Jg, dyn_aux = f.dyn_eval(Z)
            g = f.ineqs(Z)  # (T, m)
            gcost = f.grad_cost(Z)  # cost gradient (no constraint terms)

        # J^T λ assembled from the blocks (replaces a reverse-AD pass
        # through the propagators)
        def _jt(A_, B_, lmb):
            out = jnp.zeros((T, d), dtype)
            out = out.at[:-1].add(jnp.einsum("tsd,ts->td", A_, lmb))
            out = out.at[1:].add(jnp.einsum("tsd,ts->td", B_, lmb))
            return out

        jg_w = (
            jnp.einsum("tmi,tm->ti", Jg, w) if m > 0 else jnp.zeros((T, d), dtype)
        )

        E_pr_raw = jnp.max(jnp.abs(F))
        if m > 0:
            E_pr_raw = jnp.maximum(E_pr_raw, jnp.max(jnp.abs(g - sig)))

        # -------- feasibility-restoration state machine (Ipopt A-9) ------ #
        # Transitions are decided here (per instance, from last iteration's
        # line-search outcome carried in the state); the decided flags drive
        # the objective-model swap below and are persisted by
        # _iteration_post.  See SolverOptions.restoration for the design.
        if self.resto_on:
            theta_cur = jnp.sum(jnp.abs(F))
            if m > 0:
                theta_cur = theta_cur + jnp.sum(jnp.abs(g - sig))
            stall_c = jnp.where(
                state.ls_fail & (~state.in_resto),
                state.stall_count + 1,
                0,
            ).astype(jnp.int32)
            enter = (
                (~state.in_resto)
                & (stall_c >= opts.resto_trigger)
                & (theta_cur > 1e2 * opts.tol)
                & (~state.converged)
            )
            exit_ = state.in_resto & (
                (theta_cur <= opts.resto_kappa * state.resto_theta0)
                | (theta_cur <= opts.tol)
                | (state.resto_k >= opts.resto_max_iters)
            )
            in_resto = (state.in_resto | enter) & (~exit_)
            zR = jnp.where(enter, Z, state.resto_zR)
            resto_theta0 = jnp.where(enter, theta_cur, state.resto_theta0)
            resto_k = jnp.where(
                in_resto, jnp.where(enter, 1, state.resto_k + 1), 0
            ).astype(jnp.int32)
            stall_c = jnp.where(enter, 0, stall_c)
            resto_flip = enter | exit_
            # Ipopt's D_R = min(1, 1/|x_R|) proximity scaling
            Dr2 = 1.0 / jnp.maximum(1.0, zR * zR)
        else:
            in_resto = jnp.zeros((), bool)
            zR = Dr2 = None
            stall_c = resto_theta0 = resto_k = None
            resto_flip = jnp.zeros((), bool)

        if opts.recalc_y:
            # Full least-squares multiplier reset at near-feasible points
            # (the reference's recalc_y knob, /root/reference/src/
            # problem_templates/unitary_robustness_problem.jl:166):
            # lam_LS = argmin ||grad phi - Jg^T w - zl + zu - J_F^T lam||,
            # via the H = I saddle solve (same trick as initialization).
            A_m = A * free[:-1, None, :]
            B_m = Bj * free[1:, None, :]
            gother = (gcost - jg_w - has_lb * zl + has_ub * zu) * free
            eye = jnp.broadcast_to(jnp.eye(d, dtype=dtype), (T, d, d))
            Cz = jnp.zeros((T - 1, d, d), dtype)
            _, nu_ls, ok_ls = solve_kkt(
                eye, Cz, A_m, B_m, gother, jnp.zeros((T - 1, s), dtype), 1e-8
            )

            # accept the reset only if it actually shrinks the dual residual
            # (the LS solve carries an O(delta) floor; resetting past the
            # Newton iterates' accuracy would stall convergence)
            res_cur = jnp.max(jnp.abs(gother - _jt(A_m, B_m, lam)))
            res_ls = jnp.max(jnp.abs(gother - _jt(A_m, B_m, nu_ls)))
            good = (
                ok_ls
                & (E_pr_raw <= opts.recalc_y_feas_tol)
                & (res_ls < res_cur)
            )
            lam = jnp.where(good, nu_ls, lam)

        # grad phi - J^T lam - Jg^T w, assembled from the fused blocks.
        # E0/convergence always measures the ORIGINAL problem's KKT error;
        # restoration instances additionally get a swapped objective model
        # (proximity gradient) for the step computation only.
        gL = gcost - _jt(A, Bj, lam) - jg_w
        if self.resto_on:
            g_resto = opts.resto_zeta * Dr2 * (Z - zR)
            gcost_kkt = jnp.where(in_resto, g_resto, gcost)
            gL_kkt = gcost_kkt - _jt(A, Bj, lam) - jg_w
        else:
            gcost_kkt = gcost
            gL_kkt = gL
        r_dual = (gL - has_lb * zl + has_ub * zu) * free

        n_duals = (T - 1) * s + T * m + int(self._has_lb.sum() + self._has_ub.sum())
        dual_sum = (
            jnp.sum(jnp.abs(lam))
            + jnp.sum(jnp.abs(w))
            + jnp.sum(jnp.abs(zl) * has_lb)
            + jnp.sum(jnp.abs(zu) * has_ub)
        )
        s_max = 100.0
        s_d = jnp.maximum(s_max, dual_sum / max(n_duals, 1)) / s_max

        E_dual = jnp.max(jnp.abs(r_dual)) / s_d
        E_pr = E_pr_raw

        def comp_err(muv):
            e = jnp.max(jnp.abs(sl * zl - muv) * has_lb, initial=0.0)
            e = jnp.maximum(
                e, jnp.max(jnp.abs(su * zu - muv) * has_ub, initial=0.0)
            )
            if m > 0:
                e = jnp.maximum(e, jnp.max(jnp.abs(sig * w - muv)))
            return e / s_d

        E0 = jnp.maximum(jnp.maximum(E_dual, E_pr), comp_err(0.0))
        now_converged = E0 <= opts.tol

        # ---------------- barrier update ---------------- #
        mu_prev = mu
        n_comp = float(self._has_lb.sum() + self._has_ub.sum()) + T * m
        if opts.mu_strategy == "adaptive" and n_comp > 0:
            # LOQO centrality oracle (Ipopt mu_strategy=adaptive,
            # mu_oracle=loqo): mu = sigma * avg(comp) with
            # sigma = 0.1*min(0.05*(1-xi)/xi, 2)^3, xi = min(comp)/avg(comp).
            # Re-centers every iteration — no Fiacco-McCormick outer loop,
            # no extra KKT solves.
            csum = jnp.sum(sl * zl * has_lb) + jnp.sum(su * zu * has_ub)
            cmin = jnp.minimum(
                jnp.min(sl * zl, initial=jnp.inf, where=has_lb > 0),
                jnp.min(su * zu, initial=jnp.inf, where=has_ub > 0),
            )
            if m > 0:
                csum = csum + jnp.sum(sig * w)
                cmin = jnp.minimum(cmin, jnp.min(sig * w))
            avg = csum / n_comp
            xi = jnp.clip(cmin / jnp.maximum(avg, 1e-300), 1e-12, 1.0)
            sigma_c = 0.1 * jnp.minimum(0.05 * (1.0 - xi) / xi, 2.0) ** 3
            mu_loqo = sigma_c * avg
            # per-iteration trust region on the oracle (stabilization): the
            # raw LOQO target whipsaws mu across ~6 orders of magnitude on
            # ill-centered iterates (measured on min-time: lg(mu) bouncing
            # -0.2 -> -9 -> -2.6), blowing up the duals and eventually the
            # whole solve.  Limit each update to [x0.01, x10] of current mu
            # (Ipopt's adaptive globalization serves the same role).
            mu_loqo = jnp.clip(mu_loqo, 1e-2 * mu, 1e1 * mu)
            mu = jnp.clip(mu_loqo, opts.tol / 10.0, opts.mu_max)
        else:
            E_mu = jnp.maximum(jnp.maximum(E_dual, E_pr), comp_err(mu))
            mu = jnp.where(
                E_mu <= opts.kappa_epsilon * mu,
                jnp.maximum(
                    opts.tol / 10.0,
                    jnp.minimum(opts.kappa_mu * mu, mu**opts.theta_mu),
                ),
                mu,
            )
        if opts.mu_strategy == "adaptive":
            # the oracle nudges mu EVERY iteration; resetting the filter
            # each time would disable it entirely.  Reset only on a
            # substantial (>= 10x) re-centering.
            mu_changed = mu < 0.1 * mu_prev
        else:
            mu_changed = mu != mu_prev
        tau = jnp.maximum(opts.tau_min, 1.0 - mu)

        # ---------------- assemble condensed KKT blocks ---------------- #
        with jax.default_matmul_precision(eval_prec):
            if self.qn_lbfgs:
                # limited-memory BFGS: insert the curvature pair from the
                # last transition (same multipliers at both points, as Ipopt
                # does for its limited-memory mode), then
                # B = sigma*I - U M^{-1} U^T with the low-rank part applied
                # by SMW in the KKT solve
                y_vec = (
                    (gL - f.grad_lagrangian(state.qn_prevZ, lam, w)) * free
                ).reshape(-1)
                s_vec = ((Z - state.qn_prevZ) * free).reshape(-1)
                qn_S, qn_Y, qn_sty, qn_count, sig_new, acc = lbfgs_update(
                    state.qn_S, state.qn_Y, state.qn_sty, state.qn_count,
                    s_vec, y_vec,
                )
                qn_sigma = jnp.where(
                    acc, jnp.clip(sig_new, 1e-8, 1e8), state.qn_sigma
                )
                U_lr, M_lr = lbfgs_compact(
                    qn_S, qn_Y, qn_sty, qn_count, qn_sigma
                )
                H = qn_sigma * jnp.broadcast_to(
                    jnp.eye(d, dtype=dtype), (T, d, d)
                )
                C = jnp.zeros((T - 1, d, d), dtype)
            else:
                H, C = f.hess_blocks_aux(Z, lam, w, dyn_aux)
                if self.resto_on:
                    # restoration objective model: PD proximity Hessian
                    # zeta*D_R^2, no stage coupling (the defect linearization
                    # A/B rows are kept — the step is a proximal projection
                    # onto the linearized feasible manifold)
                    H_resto = jax.vmap(jnp.diag)(
                        opts.resto_zeta * Dr2
                        + jnp.zeros_like(Z)  # broadcast to (T, d)
                    )
                    H = jnp.where(in_resto, H_resto, H)
                    C = jnp.where(in_resto, jnp.zeros_like(C), C)
                qn_S = qn_Y = qn_sty = qn_count = qn_sigma = None
                U_lr = M_lr = None

        # rho*J^T J lift scale from the PRE-BARRIER Lagrangian Hessian:
        # a Gershgorin bound on the block-tridiagonal row sums |H_t| + |C_t|
        # + |C_{t-1}^T| — the indefinite part the lift must dominate.  The
        # PSD barrier terms added below are deliberately excluded.
        if self.kkt_aug_on:
            rowsum = jnp.sum(jnp.abs(H), axis=-1)  # (T, d)
            rowsum = rowsum.at[:-1].add(jnp.sum(jnp.abs(C), axis=-1))
            rowsum = rowsum.at[1:].add(jnp.sum(jnp.abs(C), axis=-2))
            rho0 = opts.kkt_aug_rho_factor * jnp.max(rowsum)
        else:
            rho0 = jnp.zeros((), Z.dtype)

        Sig_l = jnp.where(has_lb > 0, zl / sl, 0.0)
        Sig_u = jnp.where(has_ub > 0, zu / su, 0.0)
        H = H + jax.vmap(jnp.diag)(Sig_l + Sig_u)
        if m > 0:
            Sig_g = w / sig  # (T, m)
            H = H + jnp.einsum("tmi,tm,tmj->tij", Jg, Sig_g, Jg)

        # variable masking (pinned initial/final values, inactive globals)
        Mf = free  # (T, d)
        H = H * Mf[:, :, None] * Mf[:, None, :] + jax.vmap(jnp.diag)(1.0 - Mf)
        C = C * Mf[:-1, :, None] * Mf[1:, None, :]
        A = A * Mf[:-1, None, :]
        Bj = Bj * Mf[1:, None, :]

        # condensed rhs — derived from gL without a second reverse-AD pass:
        # grad_lagrangian(Z, lam, w_hat) = gL - J_g^T (w_hat - w)
        if m > 0:
            w_hat = mu / sig - (w / sig) * (g - sig)
            jg_term = jnp.einsum("tmi,tm->ti", Jg, w_hat - w)
        else:
            jg_term = 0.0
        r_z = (
            gL_kkt
            - jg_term
            - jnp.where(has_lb > 0, mu / sl, 0.0)
            + jnp.where(has_ub > 0, mu / su, 0.0)
        ) * free

        kkt_in = _KKTIn(
            H=H, C=C, A=A, B=Bj, rz=-r_z, rnu=-F, U=U_lr, M=M_lr, rho0=rho0
        )
        aux = _IterAux(
            F=F,
            g=g,
            Jg=Jg,
            mu=mu,
            tau=tau,
            sl=sl,
            su=su,
            Sig_l=Sig_l,
            Sig_u=Sig_u,
            E0=E0,
            E_dual=E_dual,
            E_pr=E_pr,
            E_comp0=comp_err(0.0),
            now_converged=now_converged,
            lam=lam,
            rz_kkt=-r_z,
            # the step model's gradient: restoration instances carry the
            # proximity gradient so the filter's Armijo/directional tests
            # match the objective the step was computed against
            gcost=gcost_kkt,
            # restoration entry/exit invalidates the filter like a barrier
            # update does
            mu_changed=mu_changed | resto_flip
            if self.resto_on
            else mu_changed,
            qn_S=qn_S,
            qn_Y=qn_Y,
            qn_sty=qn_sty,
            qn_count=qn_count,
            qn_sigma=qn_sigma,
            in_resto=in_resto if self.resto_on else None,
            resto_zR=zR,
            stall_count=stall_c,
            resto_theta0=resto_theta0,
            resto_k=resto_k,
        )
        return kkt_in, aux

    def _line_search_filter(
        self, state, aux, dz, dsig, a_pri, theta_phi,
        theta_k, phi_0, nu_pen, sl, su,
    ):
        """Wächter–Biegler filter line search (Ipopt steps A-5.4/A-6).

        A trial is acceptable when it is acceptable to every filter entry
        (theta/phi sufficient decrease) AND either passes the Armijo test on
        the barrier objective (f-type step: theta small + switching
        condition) or makes sufficient theta/phi progress vs. the current
        iterate (h-type).  Accepted h-type steps (and fallbacks) augment the
        filter; the filter is reset when the barrier parameter changes.
        Single-instance (vmapped by the caller).
        """
        opts = self.options
        nlp = self.nlp
        m = nlp.m
        Z, sig = state.Z, state.sig
        dtype = Z.dtype
        mu = aux.mu
        free = jnp.asarray(self._free, dtype)
        has_lb = jnp.asarray(self._has_lb, dtype)
        has_ub = jnp.asarray(self._has_ub, dtype)

        # directional derivative of phi along (dz, dsig)
        gphi_dz = jnp.sum(aux.gcost * dz * free)
        gphi_dz = gphi_dz - mu * jnp.sum(dz / sl * has_lb)
        gphi_dz = gphi_dz + mu * jnp.sum(dz / su * has_ub)
        if m > 0:
            gphi_dz = gphi_dz - mu * jnp.sum(dsig / sig)

        theta_min = 1e-4 * state.theta_ref
        theta_max = opts.theta_max_fact * state.theta_ref
        # barrier-parameter updates invalidate the filter (Ipopt resets it)
        flt_t = jnp.where(aux.mu_changed, jnp.inf, state.flt_theta)
        flt_p = jnp.where(aux.mu_changed, jnp.inf, state.flt_phi)

        gth, gph = opts.gamma_theta, opts.gamma_phi

        def trial(a):
            th, ph = theta_phi(Z + a * dz, sig + a * dsig)
            # acceptable to every filter slot (+inf slots auto-pass)
            f_ok = jnp.all(
                (th <= (1.0 - gth) * flt_t) | (ph <= flt_p - gph * flt_t)
            ) & (th <= theta_max)
            switching = (gphi_dz < 0) & (
                a * (-gphi_dz) ** opts.s_phi
                > opts.delta_ls * theta_k ** opts.s_theta
            )
            case1 = (theta_k <= theta_min) & switching
            armijo = ph <= phi_0 + opts.armijo_eta * a * gphi_dz
            suff = (th <= (1.0 - gth) * theta_k) | (
                ph <= phi_0 - gph * theta_k
            )
            good = f_ok & jnp.where(case1, armijo, suff)
            return th, ph, good, case1 & armijo

        def cond(carry):
            k, alpha, accepted = carry[0], carry[1], carry[2]
            return (~accepted) & (k < opts.max_ls_iters)

        def body(carry):
            k, alpha, accepted, m_acc, ftype_acc, best_a, best_m = carry
            a = a_pri * (0.5**k)
            th, ph, good, ftype = trial(a)
            mval = ph + nu_pen * th
            better = mval < best_m
            return (
                k + 1,
                jnp.where(good, a, alpha),
                accepted | good,
                jnp.where(good, mval, m_acc),
                jnp.where(good, ftype, ftype_acc),
                jnp.where(better, a, best_a),
                jnp.minimum(mval, best_m),
            )

        k_ls, alpha, accepted, m_acc, ftype_acc, best_a, best_m = (
            jax.lax.while_loop(
                cond,
                body,
                (
                    jnp.zeros((), jnp.int32),
                    jnp.zeros((), dtype),
                    jnp.zeros((), bool),
                    jnp.asarray(jnp.inf, dtype),
                    jnp.zeros((), bool),
                    jnp.zeros((), dtype),
                    jnp.asarray(jnp.inf, dtype),
                ),
            )
        )
        # fallback: best l1-merit candidate among those tried (the batched
        # restoration-phase analog)
        alpha = jnp.where(accepted, alpha, best_a)
        m_alpha = jnp.where(accepted, m_acc, best_m)

        # augment unless the accepted step was f-type (Ipopt A-6); fallbacks
        # augment too (prevents cycling around rejected regions)
        do_aug = ((~accepted) | (~ftype_acc)) & (
            (~state.converged) & (~aux.now_converged)
        )
        ptr = state.flt_ptr
        flt_t_new = jnp.where(
            do_aug, flt_t.at[ptr].set((1.0 - gth) * theta_k), flt_t
        )
        flt_p_new = jnp.where(
            do_aug, flt_p.at[ptr].set(phi_0 - gph * theta_k), flt_p
        )
        ptr_new = jnp.where(
            do_aug, (ptr + 1) % opts.filter_size, ptr
        ).astype(jnp.int32)
        return alpha, k_ls, accepted, m_alpha, flt_t_new, flt_p_new, ptr_new

    def _dir_quants(self, state: IPMState, aux: "_IterAux", dzv):
        """Slack/bound-dual directions + fraction-to-boundary steps for a
        primal direction dzv (single instance; shared by the Newton and
        second-order-correction steps)."""
        m = self.nlp.m
        dtype = state.Z.dtype
        has_lb = jnp.asarray(self._has_lb, dtype)
        has_ub = jnp.asarray(self._has_ub, dtype)
        g, Jg, mu, tau = aux.g, aux.Jg, aux.mu, aux.tau
        sl, su, Sig_l, Sig_u = aux.sl, aux.su, aux.Sig_l, aux.Sig_u
        sig, w, zl, zu = state.sig, state.w, state.zl, state.zu

        def max_step(val, dval, mask):
            # largest alpha with val + alpha*dval >= (1-tau)*val on mask
            ratio = jnp.where((dval < 0) & (mask > 0), -tau * val / dval, 1.0)
            return jnp.min(ratio, initial=1.0)

        if m > 0:
            dsig_v = jnp.einsum("tmi,ti->tm", Jg, dzv) + (g - sig)
            dw_v = mu / sig - w - (w / sig) * dsig_v
        else:
            dsig_v = sig
            dw_v = w
        dzl_v = jnp.where(has_lb > 0, mu / sl - zl - Sig_l * dzv, 0.0)
        dzu_v = jnp.where(has_ub > 0, mu / su - zu + Sig_u * dzv, 0.0)
        a_p = jnp.minimum(
            max_step(sl, dzv, has_lb), max_step(su, -dzv, has_ub)
        )
        if m > 0:
            a_p = jnp.minimum(a_p, max_step(sig, dsig_v, jnp.ones_like(sig)))
        a_d = jnp.minimum(
            max_step(zl, dzl_v, has_lb), max_step(zu, dzu_v, has_ub)
        )
        if m > 0:
            a_d = jnp.minimum(a_d, max_step(w, dw_v, jnp.ones_like(w)))
        return dsig_v, dw_v, dzl_v, dzu_v, a_p, a_d

    def _soc_step(self, state: IPMState, aux: "_IterAux", dz, fac,
                  rho_used=None, A_blk=None, B_blk=None):
        """Batched second-order-correction re-solve (Ipopt step A-5.1): the
        corrected defect rhs is built per instance at the full trial step,
        then re-solved against the KEPT factorization — batched OUTSIDE the
        instance vmap so the triton backend runs its rhs-only kernel sweeps
        (resolve_kkt_triton; triangular work only, no refactorization).

        rho_used/A_blk/B_blk: when the accepted factorization carried the
        rho*J^T J lift (kkt_aug), the re-solve rhs needs the matching
        rz + rho*J^T rnu transform.  With delta_c > 0 the lift is not an
        exact transform, so (unlike attempt(), which follows with one
        iterative-refinement pass) the SOC direction carries an
        O(rho*delta_c) error on the J^T nu term — accepted: the SOC trial
        is guarded by line-search acceptance, so an imperfect correction
        can only be rejected, never propagate."""
        opts = self.options
        f = self.funcs
        m = self.nlp.m
        eval_prec = opts.eval_precision or opts.matmul_precision

        def rhs(st, au, dzi):
            dsig, _, _, _, a_pri, _ = self._dir_quants(st, au, dzi)
            Z1 = st.Z + a_pri * dzi
            sig1 = st.sig + a_pri * dsig if m > 0 else st.sig
            with jax.default_matmul_precision(eval_prec):
                F1 = f.defects(Z1)
                g1 = f.ineqs(Z1) if m > 0 else None
            theta0 = jnp.sum(jnp.abs(au.F))
            theta1 = jnp.sum(jnp.abs(F1))
            if m > 0:
                theta0 = theta0 + jnp.sum(jnp.abs(au.g - st.sig))
                theta1 = theta1 + jnp.sum(jnp.abs(g1 - sig1))
            rnu_soc = -(a_pri * au.F + F1)
            theta_grew = theta1 >= opts.kappa_soc * theta0
            return rnu_soc, theta_grew

        rnu_soc, theta_grew = jax.vmap(rhs)(state, aux, dz)
        rz_soc = aux.rz_kkt
        if rho_used is not None and self.kkt_aug_on:
            # augmented-factor rhs transform: rz + rho * J^T rnu
            JT_r = jnp.zeros_like(rz_soc)
            JT_r = JT_r.at[:, :-1].add(
                jnp.einsum("btsd,bts->btd", A_blk, rnu_soc)
            )
            JT_r = JT_r.at[:, 1:].add(
                jnp.einsum("btsd,bts->btd", B_blk, rnu_soc)
            )
            rz_soc = rz_soc + rho_used[:, None, None] * JT_r
        if isinstance(fac, TritonFactors):
            dz_c, nu_c, ok_c = resolve_kkt_triton(
                fac, rz_soc, rnu_soc, interpret=opts.kkt_interpret
            )
        else:
            dz_c, nu_c, ok_c = jax.vmap(solve_with_factors)(
                fac, rz_soc, rnu_soc
            )
        return dz_c, nu_c, ok_c, theta_grew

    def _iteration_post(
        self,
        state: IPMState,
        aux: "_IterAux",
        dz,
        dlam,
        ok,
        dw_used,
        delta_w,
        soc=None,
    ) -> IPMState:
        opts = self.options
        nlp = self.nlp
        f = self.funcs
        T, d, s, m = nlp.T, nlp.d, nlp.s, nlp.m
        Z = state.Z
        sig, w = state.sig, state.w
        lam = aux.lam  # post-recalc_y multipliers
        zl, zu = state.zl, state.zu
        converged, n_iter = state.converged, state.n_iter
        dtype = Z.dtype

        free = jnp.asarray(self._free, dtype)
        has_lb = jnp.asarray(self._has_lb, dtype)
        has_ub = jnp.asarray(self._has_ub, dtype)
        lb = jnp.asarray(self._lb, dtype)
        ub = jnp.asarray(self._ub, dtype)

        (F, g, Jg, mu, tau, sl, su, Sig_l, Sig_u) = (
            aux.F, aux.g, aux.Jg, aux.mu, aux.tau, aux.sl, aux.su,
            aux.Sig_l, aux.Sig_u,
        )
        E0 = aux.E0
        now_converged = aux.now_converged
        # Ipopt acceptable-level termination: E0 <= acceptable_tol for
        # acceptable_iter consecutive iterations counts as convergence
        # (quasi-Newton duals can floor above `tol`; Ipopt ships the same
        # escape hatch as options acceptable_tol/acceptable_iter)
        if opts.acceptable_iter > 0:
            acc_count = jnp.where(
                E0 <= opts.acceptable_tol, state.acc_count + 1, 0
            ).astype(jnp.int32)
            now_converged = now_converged | (
                acc_count >= opts.acceptable_iter
            )
        else:
            acc_count = state.acc_count

        # ---------------- recover slack/dual directions ---------------- #
        dsig, dw_ineq, dzl, dzu, a_pri, a_dual = self._dir_quants(
            state, aux, dz
        )

        # ---------------- line search ---------------- #
        nu_pen = 1.2 * jnp.maximum(
            jnp.max(jnp.abs(lam + dlam), initial=1.0),
            jnp.max(jnp.abs(w + dw_ineq), initial=1.0) if m > 0 else 1.0,
        )

        def theta_phi_parts(val, Fv, gv, Zc, sigc):
            """(theta, phi): constraint violation and barrier objective."""
            slc = jnp.where(has_lb > 0, Zc - lb, 1.0)
            suc = jnp.where(has_ub > 0, ub - Zc, 1.0)
            barrier = jnp.sum(jnp.log(jnp.maximum(slc, 1e-300)) * has_lb)
            barrier += jnp.sum(jnp.log(jnp.maximum(suc, 1e-300)) * has_ub)
            if m > 0:
                barrier += jnp.sum(jnp.log(jnp.maximum(sigc, 1e-300)))
            theta = jnp.sum(jnp.abs(Fv))
            if m > 0:
                theta = theta + jnp.sum(jnp.abs(gv - sigc))
            return theta, val - mu * barrier

        eval_prec = opts.eval_precision or opts.matmul_precision

        if self.resto_on:
            # restoration instances evaluate trial objectives against the
            # proximity model the step was computed for (matching
            # _iteration_pre's gradient/Hessian swap)
            Dr2_p = 1.0 / jnp.maximum(1.0, aux.resto_zR * aux.resto_zR)

            def cost_eff(Zc):
                c_resto = 0.5 * opts.resto_zeta * jnp.sum(
                    Dr2_p * (Zc - aux.resto_zR) ** 2
                )
                return jnp.where(aux.in_resto, c_resto, f.total_cost(Zc))

        else:
            cost_eff = f.total_cost

        def theta_phi(Zc, sigc):
            with jax.default_matmul_precision(eval_prec):
                return theta_phi_parts(
                    cost_eff(Zc), f.defects(Zc), f.ineqs(Zc), Zc, sigc
                )

        def merit(Zc, sigc):
            th, ph = theta_phi(Zc, sigc)
            return ph + nu_pen * th

        # current point reuses the already-evaluated residuals F, g
        with jax.default_matmul_precision(eval_prec):
            theta_k, phi_0 = theta_phi_parts(cost_eff(Z), F, g, Z, sig)
        m0 = phi_0 + nu_pen * theta_k

        if opts.line_search == "filter":
            (
                alpha, k_ls, accepted, m_alpha,
                flt_theta_new, flt_phi_new, flt_ptr_new,
            ) = self._line_search_filter(
                state, aux, dz, dsig, a_pri, theta_phi,
                theta_k, phi_0, nu_pen, sl, su,
            )
        else:
            # Sequential merit backtracking with batch-wide early exit: under
            # vmap the while_loop trip count is max-over-batch of the first
            # accepted candidate, which is 1 for most iterations mid-run (the
            # batch almost always accepts the full step together), so this
            # is cheaper than evaluating all K candidates in parallel.
            def ls_cond2(carry):
                k, alpha, accepted, m_acc, best_a, best_m = carry
                return (~accepted) & (k < opts.max_ls_iters)

            def ls_body(carry):
                k, alpha, accepted, m_acc, best_a, best_m = carry
                a = a_pri * (0.5**k)
                mval = merit(Z + a * dz, sig + a * dsig)
                good = mval <= m0 - 1e-12 * jnp.abs(m0)
                better = mval < best_m
                return (
                    k + 1,
                    jnp.where(good, a, alpha),
                    accepted | good,
                    jnp.where(good, mval, m_acc),
                    jnp.where(better, a, best_a),
                    jnp.minimum(mval, best_m),
                )

            k_ls, alpha, accepted, m_acc, best_a, best_m = jax.lax.while_loop(
                ls_cond2,
                ls_body,
                (
                    jnp.zeros((), jnp.int32),
                    jnp.zeros((), dtype),
                    jnp.zeros((), bool),
                    jnp.asarray(jnp.inf, dtype),
                    jnp.zeros((), dtype),
                    jnp.asarray(jnp.inf, dtype),
                ),
            )
            # if no candidate met the decrease test, fall back to the
            # candidate with the best merit among those tried
            # (restoration-phase analog; prevents the stall of repeatedly
            # taking a fixed tiny step)
            alpha = jnp.where(accepted, alpha, best_a)
            # merit at the accepted alpha, carried out of the line search so
            # the SOC comparison below doesn't pay a redundant evaluation
            m_alpha = jnp.where(accepted, m_acc, best_m)
            flt_theta_new = flt_phi_new = flt_ptr_new = None
        alpha = jnp.where(ok, alpha, 0.0)

        # ---------------- second-order correction ---------------- #
        # Ipopt step A-5.1 (Wächter & Biegler 2006): when the full step was
        # rejected and the constraint violation grew, take the re-solved
        # corrected step (produced by _soc_step against the SAME KKT
        # factorization — triangular re-solves only) if it wins on merit.
        soc_used = jnp.zeros((), bool)
        if soc is not None:
            dz_c, nu_c, ok_c, theta_grew = soc
            dz_c = dz_c * free
            dsig_c, dw_c, dzl_c, dzu_c, a_p_c, a_d_c = self._dir_quants(
                state, aux, dz_c
            )
            m_soc = merit(Z + a_p_c * dz_c, sig + a_p_c * dsig_c)
            m_ls = m_alpha  # merit at the accepted alpha (reused, not re-evaluated)
            trigger = ((alpha < a_pri) | (~accepted)) & theta_grew
            use = (
                trigger
                & ok_c
                & (m_soc <= m0 - 1e-12 * jnp.abs(m0))
                & (m_soc < m_ls)
            )
            dz = jnp.where(use, dz_c, dz)
            dlam = jnp.where(use, -nu_c, dlam)
            dsig = jnp.where(use, dsig_c, dsig)
            dw_ineq = jnp.where(use, dw_c, dw_ineq)
            dzl = jnp.where(use, dzl_c, dzl)
            dzu = jnp.where(use, dzu_c, dzu)
            alpha = jnp.where(use, a_p_c, alpha)
            a_dual = jnp.where(use, a_d_c, a_dual)
            soc_used = use

        # ---------------- watchdog (non-monotone fallback) ---------------- #
        # Ipopt's watchdog heuristic: when the filter rejects EVERY trial
        # step, tentatively take the FULL step anyway (up to watchdog_trials
        # consecutive times, snapshotting the last safe iterate first); if
        # no filter-acceptable point appears within the trials, rewind to
        # the snapshot and cool down (the regular backtracking + best-merit
        # fallback then resumes from the safe point).
        wd_en = (
            opts.watchdog_trials > 0
            and opts.line_search == "filter"
            and state.wd_count is not None
        )
        if wd_en:
            acc_eff = accepted | soc_used
            active = state.wd_count > 0
            fail = (~acc_eff) & ok
            activate = (~active) & fail & (state.wd_cool <= 0)
            succeed = active & acc_eff
            go_on = active & fail & (state.wd_count < opts.watchdog_trials)
            rewind = active & fail & (state.wd_count >= opts.watchdog_trials)
            # tentative full fraction-to-boundary step instead of the
            # best-merit fallback
            alpha = jnp.where(activate | go_on, a_pri, alpha)
            wd_count_new = jnp.where(
                activate,
                1,
                jnp.where(
                    go_on,
                    state.wd_count + 1,
                    jnp.where(succeed | rewind, 0, state.wd_count),
                ),
            ).astype(jnp.int32)
            wd_cool_new = jnp.where(
                rewind, 3, jnp.maximum(state.wd_cool - 1, 0)
            ).astype(jnp.int32)
        else:
            rewind = jnp.zeros((), bool)

        # ---------------- updates (frozen when converged) ---------------- #
        upd = (~converged) & (~now_converged)
        scale = jnp.where(upd, 1.0, 0.0)

        Z_new = Z + scale * alpha * dz * free
        # equality multipliers are frozen across a restoration episode (the
        # proximity QP's nu estimate the projection's multipliers, not the
        # original problem's; Ipopt re-estimates duals on A-9 exit — the
        # frozen pre-entry lam plays that role here)
        lam_scale = (
            jnp.where(aux.in_resto, 0.0, scale) if self.resto_on else scale
        )
        lam_new = lam + lam_scale * alpha * dlam
        # dual safeguarding (the reference's recalc_y knob exists for exactly
        # this, unitary_robustness_problem.jl:166): runaway equality
        # multipliers poison the exact Lagrangian Hessian and stall the
        # solver.  Rescale lam back into a trust region when it blows up.
        lam_cap = 1e4
        lam_norm = jnp.max(jnp.abs(lam_new), initial=1.0)
        lam_new = lam_new * jnp.minimum(1.0, lam_cap / lam_norm)
        sig_new = sig + scale * alpha * dsig if m > 0 else sig
        if m > 0:
            # same floating-point floor as the bound slacks (mu/sig, w/sig
            # divisions downstream)
            sig_new = jnp.maximum(
                sig_new, 1e-100 if Z.dtype == jnp.float64 else 1e-30
            )
        w_new = w + scale * a_dual * dw_ineq if m > 0 else w
        zl_new = zl + scale * a_dual * dzl
        zu_new = zu + scale * a_dual * dzu

        # Ipopt kappa_Sigma safeguard: keep bound duals near mu/slack
        kappa_sig = 1e10
        tiny = 1e-100 if Z.dtype == jnp.float64 else 1e-30
        sl_new = jnp.where(has_lb > 0, jnp.maximum(Z_new - lb, tiny), 1.0)
        su_new = jnp.where(has_ub > 0, jnp.maximum(ub - Z_new, tiny), 1.0)
        zl_new = jnp.where(
            upd,
            jnp.clip(zl_new, mu / (kappa_sig * sl_new), kappa_sig * mu / sl_new)
            * has_lb,
            zl,
        )
        zu_new = jnp.where(
            upd,
            jnp.clip(zu_new, mu / (kappa_sig * su_new), kappa_sig * mu / su_new)
            * has_ub,
            zu,
        )
        if m > 0:
            w_new = jnp.where(
                upd,
                jnp.clip(
                    w_new, mu / (kappa_sig * sig_new), kappa_sig * mu / sig_new
                ),
                w,
            )

        if wd_en:
            # snapshot the pre-step iterate on activation; rewind restores
            # it verbatim (it satisfied all safeguards when it was live)
            snap = activate & upd
            rw = rewind & upd
            wd = dict(
                wd_count=jnp.where(upd, wd_count_new, state.wd_count),
                wd_cool=jnp.where(upd, wd_cool_new, state.wd_cool),
                wd_Z=jnp.where(snap, Z, state.wd_Z),
                wd_lam=jnp.where(snap, lam, state.wd_lam),
                wd_sig=jnp.where(snap, sig, state.wd_sig),
                wd_w=jnp.where(snap, w, state.wd_w),
                wd_zl=jnp.where(snap, zl, state.wd_zl),
                wd_zu=jnp.where(snap, zu, state.wd_zu),
            )
            Z_new = jnp.where(rw, state.wd_Z, Z_new)
            lam_new = jnp.where(rw, state.wd_lam, lam_new)
            sig_new = jnp.where(rw, state.wd_sig, sig_new)
            w_new = jnp.where(rw, state.wd_w, w_new)
            zl_new = jnp.where(rw, state.wd_zl, zl_new)
            zu_new = jnp.where(rw, state.wd_zu, zu_new)
        else:
            wd = {}
            rw = jnp.zeros((), bool)

        if opts.line_search == "filter":
            flt = dict(
                flt_theta=flt_theta_new,
                flt_phi=flt_phi_new,
                flt_ptr=flt_ptr_new,
                theta_ref=state.theta_ref,
            )
        else:
            flt = dict(
                flt_theta=state.flt_theta,
                flt_phi=state.flt_phi,
                flt_ptr=state.flt_ptr,
                theta_ref=state.theta_ref,
            )
        if self.qn_lbfgs:
            # persist the memory updated in _iteration_pre; advance prevZ to
            # the current iterate (the next pair spans this transition).
            # A watchdog rewind keeps the pre-excursion memory (the excursion
            # pairs describe territory the iterate just left).
            upd_qn = upd & (~rw)
            qn = dict(
                qn_S=jnp.where(upd_qn, aux.qn_S, state.qn_S),
                qn_Y=jnp.where(upd_qn, aux.qn_Y, state.qn_Y),
                qn_sty=jnp.where(upd_qn, aux.qn_sty, state.qn_sty),
                qn_count=jnp.where(upd_qn, aux.qn_count, state.qn_count),
                qn_prevZ=jnp.where(upd_qn, Z, state.qn_prevZ),
                qn_sigma=jnp.where(upd_qn, aux.qn_sigma, state.qn_sigma),
            )
        else:
            qn = {}
        if self.resto_on:
            resto = dict(
                # line-search outcome feeds the next iteration's stall
                # counter; frozen instances report no failure
                ls_fail=jnp.where(upd, ~accepted, state.ls_fail),
                stall_count=jnp.where(
                    upd, aux.stall_count, state.stall_count
                ).astype(jnp.int32),
                in_resto=jnp.where(upd, aux.in_resto, state.in_resto),
                resto_zR=jnp.where(upd, aux.resto_zR, state.resto_zR),
                resto_theta0=jnp.where(
                    upd, aux.resto_theta0, state.resto_theta0
                ),
                resto_k=jnp.where(upd, aux.resto_k, state.resto_k).astype(
                    jnp.int32
                ),
            )
        else:
            resto = {}
        return IPMState(
            Z=Z_new,
            lam=lam_new,
            sig=sig_new,
            w=w_new,
            zl=zl_new,
            zu=zu_new,
            mu=mu,
            delta_w=delta_w,
            converged=converged | now_converged,
            n_iter=n_iter + jnp.where(upd, 1, 0).astype(jnp.int32),
            kkt_err=E0,
            alpha=alpha,
            e_dual=aux.E_dual,
            e_pr=aux.E_pr,
            e_comp=aux.E_comp0,
            ls_k=k_ls,
            reg_dw=dw_used,
            alpha_du=jnp.where(upd, a_dual, 0.0),
            d_norm=jnp.max(jnp.abs(scale * alpha * dz * free)),
            acc_count=acc_count,
            **flt,
            **wd,
            **qn,
            **resto,
        )

    # ------------------------------------------------------------------ #
    # batched KKT solve with inertia-correction retries (between pre/post)
    # ------------------------------------------------------------------ #
    def _solve_kkt_batched(self, kkt_in: _KKTIn, delta_w0):
        """Solve the whole batch's KKT systems, escalating per-instance
        primal regularization on factorization failure (Ipopt schedule:
        try 0 first, then delta_last/3, then x8 per retry).

        Returns (dz, dlam, ok, dw_used, delta_w_new, fac) where fac is the
        accepted factorization for SOC re-solves — batched KKTFactors on the
        xla backend, TritonFactors on the triton backend, None otherwise
        (cr, or L-BFGS mode where the SMW-corrected operator is not
        kept)."""
        opts = self.options
        nlp = self.nlp
        H, C, A, Bj, rz, rnu = kkt_in[:6]
        U_lr, M_lr = kkt_in.U, kkt_in.M
        Bt = H.shape[0]
        dtype = H.dtype
        eye_d = jnp.eye(nlp.d, dtype=dtype)
        triton = opts.kkt_backend == "triton"
        cr = opts.kkt_backend == "cr"
        keep_fac = (
            (opts.soc or self.kkt_refine_n > 0)
            and not self.qn_lbfgs
            and not cr
        )

        def _bwhere(okv, old, new):
            return jnp.where(okv.reshape((-1,) + (1,) * (old.ndim - 1)), old, new)

        def _smw_solve(fac, rzi, rnui, Ui, Mi):
            """Apply the L-BFGS low-rank KKT correction by SMW: the zz block
            is H_base - U M^{-1} U^T, so
            x = x0 - W (-M + U^T W_z)^{-1} U^T x0_z with W = K0^{-1} [U; 0].
            Costs 2*mem extra triangular re-solves of the same factors."""
            T, d, s = nlp.T, nlp.d, nlp.s
            k2 = Ui.shape[1]
            dz0, nu0, ok0 = solve_with_factors(fac, rzi, rnui)
            RZ = Ui.reshape(T, d, k2)
            RNU = jnp.zeros((T - 1, s, k2), Ui.dtype)
            Wz, Wnu, okw = solve_with_factors(fac, RZ, RNU)
            Wzf = Wz.reshape(T * d, k2)
            Gm = -Mi + Ui.T @ Wzf
            h = jnp.linalg.solve(Gm, Ui.T @ dz0.reshape(-1))
            dz = dz0 - (Wzf @ h).reshape(T, d)
            nu = nu0 - Wnu @ h
            ok = ok0 & okw & jnp.all(jnp.isfinite(h))
            return dz, nu, ok

        def _triton_lbfgs_solve(Hreg):
            """L-BFGS SMW on the triton backend: factor the sigma*I +
            barrier base once and solve the [rz | U] multi-column rhs in ONE
            kernel sweep pair, then combine the low-rank correction with small
            per-instance (2*mem)^2 solves in XLA."""
            T, d, s = nlp.T, nlp.d, nlp.s
            k2 = U_lr.shape[-1]
            RZ = jnp.concatenate(
                [rz[..., None], U_lr.reshape(Bt, T, d, k2)], axis=-1
            )
            RNU = jnp.concatenate(
                [rnu[..., None], jnp.zeros((Bt, T - 1, s, k2), dtype)],
                axis=-1,
            )
            DZ, NU, okm = solve_kkt_triton(
                Hreg, C, A, Bj, RZ, RNU, opts.delta_c,
                interpret=opts.kkt_interpret,
            )
            dz0, Wz = DZ[..., 0], DZ[..., 1:]
            nu0, Wnu = NU[..., 0], NU[..., 1:]
            Wzf = Wz.reshape(Bt, T * d, k2)
            Gm = -M_lr + jnp.einsum("bnk,bnl->bkl", U_lr, Wzf)
            h = jnp.linalg.solve(
                Gm,
                jnp.einsum("bnk,bn->bk", U_lr, dz0.reshape(Bt, -1))[..., None],
            )[..., 0]
            dz = dz0 - jnp.einsum("bnk,bk->bn", Wzf, h).reshape(Bt, T, d)
            nu = nu0 - jnp.einsum("btsk,bk->bts", Wnu, h)
            ok = okm & jnp.isfinite(h).all(axis=-1)
            return dz, nu, ok

        def _cr_smw(h, c, a, b, rzi, rnui, Ui, Mi):
            """L-BFGS SMW on the cyclic-reduction backend: the [rz | U]
            multi-column rhs goes through ONE parallel-in-T reduction, then
            the low-rank correction is a small (2*mem)^2 solve."""
            T, d, s = nlp.T, nlp.d, nlp.s
            k2 = Ui.shape[1]
            RZ = jnp.concatenate(
                [rzi[..., None], Ui.reshape(T, d, k2)], axis=-1
            )
            RNU = jnp.concatenate(
                [rnui[..., None], jnp.zeros((T - 1, s, k2), Ui.dtype)],
                axis=-1,
            )
            DZ, NU, okm = solve_kkt_cr(h, c, a, b, RZ, RNU, opts.delta_c)
            dz0, Wz = DZ[..., 0], DZ[..., 1:]
            nu0, Wnu = NU[..., 0], NU[..., 1:]
            Wzf = Wz.reshape(T * d, k2)
            Gm = -Mi + Ui.T @ Wzf
            hh = jnp.linalg.solve(Gm, Ui.T @ dz0.reshape(-1))
            dzi = dz0 - (Wzf @ hh).reshape(T, d)
            nui = nu0 - Wnu @ hh
            return dzi, nui, okm & jnp.all(jnp.isfinite(hh))

        # rho*J^T J inertia lift (see SolverOptions.kkt_aug): an EXACT
        # transform of the saddle system — adding rho*J^T*(J dz - rnu) = 0
        # to the z rows gives (H + rho J^T J) dz + J^T nu = rz + rho J^T rnu
        # with the SAME solution (dz, nu) — that keeps the block-tridiagonal
        # structure (J is block-bidiagonal, so J^T J is block-tridiagonal)
        # while making the stage-wise Cholesky PD condition track the true
        # reduced-Hessian inertia instead of demanding delta_w ~ ||H||.
        aug_on = self.kkt_aug_on
        if aug_on:
            # per-instance lift scale: must dominate the PRE-BARRIER
            # Lagrangian curvature (computed in _iteration_pre; the PSD
            # barrier terms are excluded — see _KKTIn.rho0).  L-BFGS mode is
            # excluded: its sigma*I base Hessian is PD by construction, so
            # the lift never has work to do there.
            rho_base = kkt_in.rho0
            S_AA = jnp.zeros_like(H)
            S_AA = S_AA.at[:, :-1].add(jnp.einsum("btsi,btsj->btij", A, A))
            S_AA = S_AA.at[:, 1:].add(jnp.einsum("btsi,btsj->btij", Bj, Bj))
            S_AB = jnp.einsum("btsi,btsj->btij", A, Bj)  # (B, T-1, d, d)
        else:
            rho_base = jnp.zeros((Bt,), dtype)
            S_AA = S_AB = None

        def _jt_lift(rho, rz_v, rnu_v):
            """Augmented-system rhs transform rz + rho * J^T rnu."""
            JT_v = jnp.zeros_like(rz_v)
            JT_v = JT_v.at[:, :-1].add(
                jnp.einsum("btsd,bts->btd", A, rnu_v)
            )
            JT_v = JT_v.at[:, 1:].add(
                jnp.einsum("btsd,bts->btd", Bj, rnu_v)
            )
            return rz_v + rho[:, None, None] * JT_v

        def attempt(dw, rho, rz_v, rnu_v):
            """One factorization attempt; with the lift active, ONE
            factor-reusing iterative-refinement pass against the ORIGINAL
            (delta_c-regularized) system corrects the rho-conditioning
            noise (measured to floor the dual residual at ~0.4 without
            it)."""
            Hreg = H + dw[:, None, None, None] * eye_d
            if aug_on:
                re = rho[:, None, None, None]
                Hreg = Hreg + re * S_AA
                C_in = C + re * S_AB
                rz_in = _jt_lift(rho, rz_v, rnu_v)
            else:
                C_in, rz_in = C, rz_v
            rnu = rnu_v

            resolve = None  # rhs-only re-solve against the SAME factors
            fac_carry = ()
            if cr:  # block cyclic reduction: parallel-in-T latency path
                if self.qn_lbfgs:
                    dz, nu, ok = jax.vmap(_cr_smw)(
                        Hreg, C_in, A, Bj, rz_in, rnu, U_lr, M_lr
                    )
                else:
                    dz, nu, ok = jax.vmap(
                        lambda h, c, a, b, z, n: solve_kkt_cr(
                            h, c, a, b, z, n, opts.delta_c
                        )
                    )(Hreg, C_in, A, Bj, rz_in, rnu)

                    def resolve(rz2, rnu2):
                        return jax.vmap(
                            lambda h, c, a, b, z, n: solve_kkt_cr(
                                h, c, a, b, z, n, opts.delta_c
                            )
                        )(Hreg, C_in, A, Bj, rz2, rnu2)

            elif triton:
                if self.qn_lbfgs:
                    dz, nu, ok = _triton_lbfgs_solve(Hreg)
                else:
                    dz, nu, ok, fact = solve_kkt_triton(
                        Hreg, C_in, A, Bj, rz_in, rnu, opts.delta_c,
                        interpret=opts.kkt_interpret, want_factors=True,
                    )
                    if keep_fac:
                        # constraint blocks are dw-independent; carry only
                        # the dw-dependent factors
                        fac_carry = (fact.LP, fact.LS, fact.XA, fact.G, fact.LPf)

                    def resolve(rz2, rnu2):
                        return resolve_kkt_triton(
                            fact, rz2, rnu2, interpret=opts.kkt_interpret
                        )

            else:
                fac = jax.vmap(
                    lambda h, c, a, b: factor_kkt(h, c, a, b, opts.delta_c)
                )(Hreg, C_in, A, Bj)
                if self.qn_lbfgs:
                    dz, nu, ok = jax.vmap(_smw_solve)(
                        fac, rz_in, rnu, U_lr, M_lr
                    )
                else:
                    dz, nu, ok = jax.vmap(solve_with_factors)(fac, rz_in, rnu)

                    def resolve(rz2, rnu2):
                        return jax.vmap(solve_with_factors)(fac, rz2, rnu2)

                if keep_fac:
                    fac_carry = (
                        fac.L_P, fac.L_S, fac.X_A, fac.G, fac.L_final
                    )

            # refinement: residual of the ORIGINAL system at (dz, nu),
            # corrected through the kept factors (triangular work only on
            # the xla/triton paths — no refactorization).  One pass is
            # mandatory with the rho lift (corrects rho-conditioning
            # noise); opts.kkt_refine adds passes on ANY factor-keeping
            # backend (rho=0 makes the _jt_lift transform inert).
            n_ref = max(self.kkt_refine_n, 1 if aug_on else 0)
            if n_ref > 0 and resolve is not None:
                for _ in range(n_ref):
                    Hdz = (
                        jnp.einsum("btij,btj->bti", H, dz)
                        + dw[:, None, None] * dz
                    )
                    Hdz = Hdz.at[:, :-1].add(
                        jnp.einsum("btij,btj->bti", C, dz[:, 1:])
                    )
                    Hdz = Hdz.at[:, 1:].add(
                        jnp.einsum("btji,btj->bti", C, dz[:, :-1])
                    )
                    JTnu = jnp.zeros_like(dz)
                    JTnu = JTnu.at[:, :-1].add(
                        jnp.einsum("btsd,bts->btd", A, nu)
                    )
                    JTnu = JTnu.at[:, 1:].add(
                        jnp.einsum("btsd,bts->btd", Bj, nu)
                    )
                    r1 = Hdz + JTnu - rz_v
                    Jdz = jnp.einsum(
                        "btsd,btd->bts", A, dz[:, :-1]
                    ) + jnp.einsum("btsd,btd->bts", Bj, dz[:, 1:])
                    r2 = Jdz - opts.delta_c * nu - rnu_v
                    ez, enu, okr = resolve(_jt_lift(rho, -r1, -r2), -r2)
                    dz = dz + jnp.where(okr[:, None, None], ez, 0.0)
                    nu = nu + jnp.where(okr[:, None, None], enu, 0.0)

            return dz, nu, ok, fac_carry

        def cond_fn(carry):
            k, dw_try, dw_used, rho_used, dz, nu, ok, facc = carry
            return (~ok.all()) & (k < 12)

        # retry warm start: instances whose previous iteration accepted a
        # regularized factorization start their k=0 attempt at dw_prev/3
        # with the lift engaged, skipping the known-doomed plain attempt
        # (per instance — cold instances still try pure Newton first).
        # Once dw_prev/3 decays below kkt_retry_warm_min the instance
        # resumes the dw=0 attempt, recovering the Newton endgame.
        if self.retry_warm_on:
            dw_warm = jnp.where(
                delta_w0 / 3.0 >= opts.kkt_retry_warm_min,
                jnp.maximum(opts.delta_w_min, delta_w0 / 3.0),
                0.0,
            )
        else:
            dw_warm = jnp.zeros((Bt,), dtype)

        def body_fn(carry):
            k, dw_try, dw_used, rho_used, dz, nu, ok, facc = carry
            dw_next = jnp.where(
                k == 0,
                dw_warm,
                jnp.where(
                    # per-instance escalation: a failed dw=0 attempt moves
                    # to the first regularization level; a failed dw>0
                    # attempt escalates x8 (Ipopt A-5 kappa_w^+)
                    dw_try == 0.0,
                    jnp.where(
                        delta_w0 > 0,
                        jnp.maximum(opts.delta_w_min, delta_w0 / 3.0),
                        1e-4,
                    ),
                    jnp.minimum(dw_try * 8.0, opts.delta_w_max),
                ),
            )
            # engage the rho*J^T J lift from the kkt_aug_start-th retry:
            # the k=0 plain dw=0 attempt keeps the fast path bit-identical
            # for well-conditioned instances AND preserves the
            # quadratic-convergence endgame (an aug+dw=0 "memory" shortcut
            # for hard instances was measured to degrade the leakage tail
            # 0.906 -> 0.781: near-semidefinite augmented dw=0 steps are
            # poor).  Warm-started dw>0 first attempts carry the lift too
            # (the accepted config they resume WAS lift+dw).
            rho_next = (
                jnp.where(
                    (k >= opts.kkt_aug_start)
                    | (self.retry_warm_on & (dw_next > 0)),
                    rho_base,
                    0.0,
                )
                if aug_on
                else rho_base  # zeros when the lift is off
            )
            dz2, nu2, ok2, facc2 = attempt(dw_next, rho_next, rz, rnu)
            # keep already-successful instances' results
            dz = jnp.where(ok[:, None, None], dz, dz2)
            nu = jnp.where(ok[:, None, None], nu, nu2)
            facc = jax.tree_util.tree_map(
                lambda old, new: _bwhere(ok, old, new), facc, facc2
            )
            dw_used = jnp.where(ok, dw_used, dw_next)
            rho_used = jnp.where(ok, rho_used, rho_next)
            return (k + 1, dw_next, dw_used, rho_used, dz, nu, ok | ok2, facc)

        T, d, s = nlp.T, nlp.d, nlp.s
        if keep_fac:
            # the triton factors are padded to power-of-two tiles
            dk, sk = (tile_dim(d), tile_dim(s)) if triton else (d, s)
            fac0 = (
                jnp.zeros((Bt, T - 1, dk, dk), dtype),
                jnp.zeros((Bt, T - 1, sk, sk), dtype),
                jnp.zeros((Bt, T - 1, dk, sk), dtype),
                jnp.zeros((Bt, T - 1, sk, dk), dtype),
                jnp.zeros((Bt, dk, dk), dtype),
            )
        else:
            fac0 = ()
        init = (
            jnp.zeros((), jnp.int32),
            jnp.zeros((Bt,), dtype),
            jnp.zeros((Bt,), dtype),
            jnp.zeros((Bt,), dtype),
            jnp.zeros((Bt, T, d), dtype),
            jnp.zeros((Bt, T - 1, s), dtype),
            jnp.zeros((Bt,), bool),
            fac0,
        )
        _, _, dw_used, rho_used, dz, nu, ok, facc = jax.lax.while_loop(
            cond_fn, body_fn, init
        )
        delta_w_new = jnp.where(dw_used > 0, dw_used, delta_w0)
        dz = jnp.where(ok[:, None, None], dz, 0.0)
        dlam = -jnp.where(ok[:, None, None], nu, 0.0)
        if keep_fac:
            # the kept factors belong to the (possibly rho-augmented) system
            # of the ACCEPTED attempt — store the matching coupling blocks
            # so re-solves (SOC) are consistent, and hand back rho_used so
            # the re-solve rhs gets the same J^T transform
            C_used = (
                C + rho_used[:, None, None, None] * S_AB
                if aug_on
                else C
            )
        if keep_fac and triton:
            fac = TritonFactors(*facc, C_used, A, Bj)
        elif keep_fac:
            fac = KKTFactors(
                facc[0], facc[1], facc[2], facc[3], facc[4], C_used, A, Bj
            )
        else:
            fac = None
        return dz, dlam, ok, dw_used, delta_w_new, fac, rho_used

    def _step_impl(self, state: IPMState) -> IPMState:
        # named scopes tag the device ops of each phase in profiler traces
        # (scripts/kkt_backend_ab.py reduces a trace by these names)
        with jax.named_scope("qct_assembly"):
            kkt_in, aux = jax.vmap(self._iteration_pre)(state)
        with jax.named_scope("qct_kkt"):
            dz, dlam, ok, dw_used, delta_w_new, fac, rho_used = (
                self._solve_kkt_batched(kkt_in, state.delta_w)
            )
        with jax.named_scope("qct_post"):
            if fac is None or not self.options.soc:
                # factors may be kept for kkt_refine without soc: skip A-5.1
                return jax.vmap(
                    lambda st, au, a, b, c, d_, e: self._iteration_post(
                        st, au, a, b, c, d_, e, None
                    )
                )(state, aux, dz, dlam, ok, dw_used, delta_w_new)
            soc_data = self._soc_step(
                state, aux, dz, fac, rho_used, kkt_in.A, kkt_in.B
            )
            return jax.vmap(self._iteration_post)(
                state, aux, dz, dlam, ok, dw_used, delta_w_new, soc_data
            )

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    @partial(jax.jit, static_argnums=(0,))
    def _init_state_jit(self, Z0):
        # one compiled initialization instead of hundreds of eager ops
        return self.init_state(Z0)

    @partial(jax.jit, static_argnums=(0,))
    def _batched_cost(self, Z):
        return jax.vmap(self.funcs.total_cost)(Z)

    @partial(jax.jit, static_argnums=(0,))
    def step(self, state: IPMState) -> IPMState:
        """One batched IPM iteration.

        NOT donated: the callback protocol hands users the IPMState, which
        they may legitimately hold across iterations (history callbacks);
        the no-callback `_solve_loop` path donates instead.
        """
        # full f32 matmul precision: reduced-precision products (TF32 on the
        # GPU) are not enough for the condensed KKT arithmetic
        with jax.default_matmul_precision(self.options.matmul_precision):
            return self._step_impl(state)

    def solve(
        self, Z0, *, max_iter=None, callback=None, segment_iters=None
    ) -> IPMResult:
        """Run the IPM to convergence or max_iter.

        Z0: (B, T, d).  With callback (called with (iter, IPMState) each
        iteration; return False to stop — mirroring the reference's Ipopt
        intermediate-callback protocol,
        /root/reference/docs/literate/man/ipopt_callbacks.jl:17-37),
        iterations run one jitted step per Python loop turn.  Without, the
        whole loop is a single lax.while_loop on device.

        segment_iters: if set (and no callback), run the device loop as
        resumable segments of at most this many iterations instead of one
        long call, bounding the length of any single device call.  Segments
        chain exactly (IPMState is the while_loop carry, so the iterate
        sequence is bitwise identical) at the cost of one host convergence
        check per segment.
        Ignored on the per-step host-loop path, i.e. when a callback is
        given OR print_level >= 5 activates the live iteration table
        (each iteration is already its own device call there).
        """
        max_iter = max_iter or self.options.max_iter
        if segment_iters is not None and int(segment_iters) < 1:
            raise ValueError(
                f"segment_iters must be >= 1, got {segment_iters}"
            )
        state = self._init_state_jit(jnp.asarray(Z0))

        live_table = self.options.print_level >= 5
        if callback is not None or live_table:
            if live_table:
                print(
                    f"{'iter':>4} {'objective':>14} {'inf_pr':>9} "
                    f"{'inf_du':>9} {'lg(mu)':>7} {'||d||':>9} "
                    f"{'lg(rg)':>7} {'alpha_du':>9} {'alpha_pr':>9} {'ls':>3}"
                )
            for k in range(max_iter):
                state = self.step(state)
                if live_table:
                    self._print_iter_row(k, state)
                if callback is not None and callback(k, state) is False:
                    break
                if bool(jnp.all(state.converged)):
                    break
        elif segment_iters:
            done = 0
            early = jax.process_count() == 1
            while done < max_iter:
                n = min(int(segment_iters), max_iter - done)
                state = self._solve_loop(state, n, early)
                done += n
                if bool(jnp.all(state.converged)):
                    break
        else:
            # multi-process meshes drop the per-iteration all-converged
            # vote (see _solve_loop early_exit)
            state = self._solve_loop(
                state, max_iter, jax.process_count() == 1
            )

        obj = self._batched_cost(state.Z)
        Z_out = (
            state.Z * jnp.asarray(self.var_scale, state.Z.dtype)
            if self.options.nlp_scaling
            else state.Z
        )
        return IPMResult(
            Z=Z_out,
            lam=state.lam,
            converged=state.converged,
            n_iter=state.n_iter,
            kkt_err=state.kkt_err,
            mu=state.mu,
            objective=obj,
        )

    def iteration_stats(self, state: IPMState, b: int = 0) -> dict:
        """Host-side per-iteration stats for instance b, shaped like Ipopt's
        intermediate-callback tuple (/root/reference/docs/literate/man/
        ipopt_callbacks.jl:17-31).  Objective is reported in PROBLEM units
        (NLP scaling undone)."""
        obj = float(self._batched_cost(state.Z)[b]) / self.obj_scale
        return {
            "iter_count": int(state.n_iter[b]),
            "obj_value": obj,
            "inf_pr": float(state.e_pr[b]),
            "inf_du": float(state.e_dual[b]),
            "mu": float(state.mu[b]),
            "d_norm": float(state.d_norm[b]),
            "regularization_size": float(state.reg_dw[b]),
            "alpha_du": float(state.alpha_du[b]),
            "alpha_pr": float(state.alpha[b]),
            "ls_trials": int(state.ls_k[b]),
        }

    def _print_iter_row(self, k: int, state: IPMState):
        import math as _math

        st = self.iteration_stats(state, 0)
        rg = st["regularization_size"]
        lg_rg = f"{_math.log10(rg):7.1f}" if rg > 0 else "      -"
        mu = max(st["mu"], 1e-300)
        print(
            f"{k:>4} {st['obj_value']:>14.7e} {st['inf_pr']:>9.2e} "
            f"{st['inf_du']:>9.2e} {_math.log10(mu):>7.1f} "
            f"{st['d_norm']:>9.2e} {lg_rg} {st['alpha_du']:>9.2e} "
            f"{st['alpha_pr']:>9.2e} {st['ls_trials']:>3}"
        )

    def _solve_loop_impl(
        self, state: IPMState, max_iter: int, early_exit: bool = True
    ) -> IPMState:
        """Undecorated loop body — called directly inside shard_map by the
        multi-process path (parallel.batched_solve), where the per-shard
        trace must not re-enter jit."""
        return self._solve_loop_body(state, max_iter, early_exit)

    @partial(jax.jit, static_argnums=(0, 2, 3), donate_argnums=(1,))
    def _solve_loop(
        self, state: IPMState, max_iter: int, early_exit: bool = True
    ) -> IPMState:
        return self._solve_loop_body(state, max_iter, early_exit)

    def _solve_loop_body(
        self, state: IPMState, max_iter: int, early_exit: bool = True
    ) -> IPMState:
        # donate_argnums: the initial state's buffers are reused for the
        # while_loop carry (no extra copy; ignored when traced inside an
        # outer jit such as bench.py's solve wrapper)
        #
        # early_exit=False drops the all-converged vote from the loop
        # condition: on a MULTI-PROCESS mesh that vote is a cross-process
        # pred[] all-reduce EVERY iteration (measured 53 ms/iter of pure
        # collective latency over localhost TCP — 1.4x total wall), while
        # converged instances are frozen by the per-instance `upd` masking
        # regardless, so a fixed-trip loop computes the identical result
        # with ZERO cross-process traffic during the solve.
        def cond(carry):
            k, st = carry
            if early_exit:
                return (k < max_iter) & (~jnp.all(st.converged))
            return k < max_iter

        def body(carry):
            k, st = carry
            return (k + 1, self._step_impl(st))

        with jax.default_matmul_precision(self.options.matmul_precision):
            _, final = jax.lax.while_loop(
                cond, body, (jnp.zeros((), jnp.int32), state)
            )
        return final
