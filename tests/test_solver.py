"""Solver tests: KKT factorization exactness, IPM convergence on analytic
problems (LQR with known solution, bound-constrained QP, inequality
constraints), batching, and regularization retries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quantumcollocation_tpu.solver import (
    InteriorPointSolver,
    SolverOptions,
    StageNLP,
    solve_kkt,
)
from quantumcollocation_tpu.solver.kkt import factor_kkt, solve_with_factors


class TestKKT:
    def test_matches_dense_solve(self):
        rng = np.random.default_rng(0)
        T, d, s = 5, 4, 2
        delta_c = 1e-8
        H = np.stack([np.eye(d) * 2 + 0.1 * rng.normal(size=(d, d)) for _ in range(T)])
        H = 0.5 * (H + H.transpose(0, 2, 1))
        C = 0.1 * rng.normal(size=(T - 1, d, d))
        A = rng.normal(size=(T - 1, s, d))
        B = rng.normal(size=(T - 1, s, d))
        rz = rng.normal(size=(T, d))
        rnu = rng.normal(size=(T - 1, s))

        n = T * d + (T - 1) * s
        K = np.zeros((n, n))
        for t in range(T):
            K[t * d:(t + 1) * d, t * d:(t + 1) * d] = H[t]
        for t in range(T - 1):
            K[t * d:(t + 1) * d, (t + 1) * d:(t + 2) * d] = C[t]
            K[(t + 1) * d:(t + 2) * d, t * d:(t + 1) * d] = C[t].T
            r0 = T * d + t * s
            K[r0:r0 + s, t * d:(t + 1) * d] = A[t]
            K[r0:r0 + s, (t + 1) * d:(t + 2) * d] = B[t]
            K[t * d:(t + 1) * d, r0:r0 + s] = A[t].T
            K[(t + 1) * d:(t + 2) * d, r0:r0 + s] = B[t].T
            K[r0:r0 + s, r0:r0 + s] = -delta_c * np.eye(s)
        sol = np.linalg.solve(
            K, np.concatenate([rz.reshape(-1), rnu.reshape(-1)])
        )
        dz, nu, ok = solve_kkt(
            jnp.asarray(H), jnp.asarray(C), jnp.asarray(A), jnp.asarray(B),
            jnp.asarray(rz), jnp.asarray(rnu), delta_c,
        )
        assert bool(ok)
        np.testing.assert_allclose(
            np.asarray(dz), sol[: T * d].reshape(T, d), atol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(nu), sol[T * d:].reshape(T - 1, s), atol=1e-9
        )

    def test_singular_H_detected(self):
        T, d, s = 3, 2, 1
        H = jnp.zeros((T, d, d))  # singular -> cholesky NaN
        C = jnp.zeros((T - 1, d, d))
        A = jnp.ones((T - 1, s, d))
        B = jnp.ones((T - 1, s, d))
        dz, nu, ok = solve_kkt(
            H, C, A, B, jnp.ones((T, d)), jnp.ones((T - 1, s)), 1e-8
        )
        assert not bool(ok)


def _double_integrator_nlp(T=20, dt=0.1, u_bound=None, terminal_ineq=False):
    """min sum u_t^2*dt + 50*(x_T - 1)^2 (+ v_T^2)  s.t. double-integrator
    dynamics, x_0 = v_0 = 0.  d = (x, v, u)."""
    d, s = 3, 2
    m = 1 if terminal_ineq else 0

    def stage_cost(z, t):
        return 0.5 * dt * z[2] ** 2

    def pair_cost(zt, ztp1, t):
        return 0.0

    def terminal_cost(zT):
        return 50.0 * (zT[0] - 1.0) ** 2 + 10.0 * zT[1] ** 2

    def defect(zt, ztp1, t):
        return jnp.array(
            [
                ztp1[0] - zt[0] - zt[1] * dt,
                ztp1[1] - zt[1] - zt[2] * dt,
            ]
        )

    def ineq(z, t):
        if m == 0:
            return jnp.zeros((0,))
        # x_T <= 0.8  (active at the optimum since unconstrained opt -> 1)
        return jnp.where(t == T - 1, 0.8 - z[0], 1.0)[None]

    lb = np.full((T, d), -np.inf)
    ub = np.full((T, d), np.inf)
    if u_bound is not None:
        lb[:, 2] = -u_bound
        ub[:, 2] = u_bound
    free = np.ones((T, d), bool)
    free[0, 0] = free[0, 1] = False  # x_0 = v_0 = 0 pinned
    z0 = np.zeros((T, d))
    return StageNLP(
        T=T, d=d, s=s, m=m,
        stage_cost=stage_cost, pair_cost=pair_cost,
        terminal_cost=terminal_cost, defect=defect, ineq=ineq,
        lb=lb, ub=ub, free_mask=free, z0=z0,
    )


class TestIPM:
    def test_equality_constrained_lqr(self):
        nlp = _double_integrator_nlp()
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        res = solver.solve(jnp.asarray(nlp.z0)[None], max_iter=50)
        assert bool(res.converged[0]), f"kkt_err={res.kkt_err}"
        Z = np.asarray(res.Z[0])
        # dynamics satisfied
        for t in range(nlp.T - 1):
            np.testing.assert_allclose(
                Z[t + 1, 0], Z[t, 0] + Z[t, 1] * 0.1, atol=1e-7
            )
        # reaches near the target
        assert abs(Z[-1, 0] - 1.0) < 0.15
        # initial conditions pinned
        assert Z[0, 0] == 0.0 and Z[0, 1] == 0.0

    def test_control_bounds_respected(self):
        nlp = _double_integrator_nlp(u_bound=1.0)
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        res = solver.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res.converged[0])
        Z = np.asarray(res.Z[0])
        assert np.all(np.abs(Z[:, 2]) <= 1.0 + 1e-8)

    def test_terminal_inequality_active(self):
        nlp = _double_integrator_nlp(terminal_ineq=True)
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        res = solver.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res.converged[0])
        Z = np.asarray(res.Z[0])
        # constraint x_T <= 0.8 should be active (unconstrained opt ~ 1.0)
        assert Z[-1, 0] <= 0.8 + 1e-6
        assert Z[-1, 0] >= 0.75

    def test_batched_multistart(self):
        nlp = _double_integrator_nlp()
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        rng = np.random.default_rng(0)
        Z0 = np.zeros((4, nlp.T, nlp.d))
        Z0 += 0.1 * rng.normal(size=Z0.shape)
        Z0[:, 0, :2] = 0.0
        res = solver.solve(jnp.asarray(Z0), max_iter=60)
        assert bool(jnp.all(res.converged))
        # all seeds reach the same optimum (convex problem)
        Zs = np.asarray(res.Z)
        for b in range(1, 4):
            np.testing.assert_allclose(Zs[b, -1, 0], Zs[0, -1, 0], atol=1e-5)

    def test_segmented_solve_matches_single_call(self):
        # segment_iters chains _solve_loop calls through the IPMState carry:
        # the iterate sequence must be identical to one long device call
        # (bounds the length of any single device call)
        nlp = _double_integrator_nlp(u_bound=1.0)
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        Z0 = jnp.asarray(nlp.z0)[None]
        res_one = solver.solve(Z0, max_iter=40)
        res_seg = solver.solve(Z0, max_iter=40, segment_iters=7)
        assert bool(res_seg.converged[0])
        np.testing.assert_allclose(
            np.asarray(res_seg.Z), np.asarray(res_one.Z), atol=1e-12
        )
        assert int(res_seg.n_iter[0]) == int(res_one.n_iter[0])

    def test_callback_protocol(self):
        nlp = _double_integrator_nlp()
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        iters = []

        def cb(k, state):
            iters.append(k)
            return False  # stop immediately

        solver.solve(jnp.asarray(nlp.z0)[None], max_iter=50, callback=cb)
        assert iters == [0]

        # without early stop, the callback sees every iteration until
        # convergence (exact-Newton on an equality QP converges fast)
        seen = []
        solver.solve(
            jnp.asarray(nlp.z0)[None],
            max_iter=50,
            callback=lambda k, st: seen.append(k) or True,
        )
        assert seen == list(range(len(seen))) and 1 <= len(seen) <= 10

    def test_factor_resolve_matches_fused_solve(self):
        # second-order corrections re-solve the SAME factorization with a
        # new rhs; the split path must agree with the fused one exactly
        rng = np.random.default_rng(3)
        T, d, s = 6, 4, 2
        H = np.stack([np.eye(d) * 3 + 0.1 * rng.normal(size=(d, d)) for _ in range(T)])
        H = 0.5 * (H + H.transpose(0, 2, 1))
        C = 0.1 * rng.normal(size=(T - 1, d, d))
        A = rng.normal(size=(T - 1, s, d))
        B = rng.normal(size=(T - 1, s, d))
        fac = factor_kkt(
            jnp.asarray(H), jnp.asarray(C), jnp.asarray(A), jnp.asarray(B), 1e-8
        )
        for seed in range(2):
            r = np.random.default_rng(seed)
            rz = jnp.asarray(r.normal(size=(T, d)))
            rnu = jnp.asarray(r.normal(size=(T - 1, s)))
            dz1, nu1, ok1 = solve_kkt(
                jnp.asarray(H), jnp.asarray(C), jnp.asarray(A), jnp.asarray(B),
                rz, rnu, 1e-8,
            )
            dz2, nu2, ok2 = solve_with_factors(fac, rz, rnu)
            assert bool(ok1) and bool(ok2)
            np.testing.assert_allclose(np.asarray(dz1), np.asarray(dz2), atol=1e-12)
            np.testing.assert_allclose(np.asarray(nu1), np.asarray(nu2), atol=1e-12)

    def test_soc_and_recalc_y_converge_to_same_optimum(self):
        # enabling the second-order correction and the least-squares
        # multiplier reset must not change the optimum of a well-posed
        # problem (they only alter the path), and everything still converges
        nlp = _double_integrator_nlp(u_bound=1.0, terminal_ineq=True)
        base = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        res0 = base.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res0.converged[0])

        soc = InteriorPointSolver(nlp, SolverOptions(tol=1e-8, soc=True))
        res1 = soc.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res1.converged[0])
        np.testing.assert_allclose(
            np.asarray(res1.Z[0, -1, 0]), np.asarray(res0.Z[0, -1, 0]), atol=1e-5
        )

        ry = InteriorPointSolver(
            nlp, SolverOptions(tol=1e-8, recalc_y=True, recalc_y_feas_tol=1e-4)
        )
        res2 = ry.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res2.converged[0])
        np.testing.assert_allclose(
            np.asarray(res2.Z[0, -1, 0]), np.asarray(res0.Z[0, -1, 0]), atol=1e-5
        )

    def test_lbfgs_compact_secant_property(self):
        # B = sigma*I - U M^{-1} U^T must satisfy the most recent secant
        # equation B s = y (standard compact-form identity)
        from quantumcollocation_tpu.solver.lbfgs import (
            lbfgs_compact,
            lbfgs_update,
        )

        rng = np.random.default_rng(0)
        n, mem = 12, 4
        S = jnp.zeros((mem, n))
        Y = jnp.zeros((mem, n))
        sty = jnp.zeros((mem,))
        count = jnp.asarray(0, jnp.int32)
        sigma = jnp.asarray(1.0)
        Aspd = rng.normal(size=(n, n))
        Aspd = Aspd @ Aspd.T + n * np.eye(n)  # SPD "true" Hessian
        for _ in range(6):
            s = jnp.asarray(rng.normal(size=n))
            y = jnp.asarray(Aspd @ np.asarray(s))  # guarantees s^T y > 0
            S, Y, sty, count, sig_new, acc = lbfgs_update(S, Y, sty, count, s, y)
            assert bool(acc)
            sigma = sig_new
        U, M = lbfgs_compact(S, Y, sty, count, sigma)
        Bmat = float(sigma) * np.eye(n) - np.asarray(
            U @ jnp.linalg.solve(M, U.T)
        )
        np.testing.assert_allclose(Bmat @ np.asarray(S[-1]), np.asarray(Y[-1]), rtol=1e-8)
        # SPD (curvature condition enforced by the skip rule)
        assert np.all(np.linalg.eigvalsh(0.5 * (Bmat + Bmat.T)) > 0)

    def test_lbfgs_mode_converges(self):
        # quasi-Newton (Ipopt hessian_approximation=limited-memory analog):
        # must reach the same optimum as the exact-Hessian mode
        nlp = _double_integrator_nlp(u_bound=1.0)
        ex = InteriorPointSolver(nlp, SolverOptions(tol=1e-7))
        r0 = ex.solve(jnp.asarray(nlp.z0)[None], max_iter=100)
        qn = InteriorPointSolver(
            nlp, SolverOptions(tol=1e-5, quasi_newton="lbfgs"),
            exact_hessian=False,
        )
        r1 = qn.solve(jnp.asarray(nlp.z0)[None], max_iter=300)
        assert bool(r1.converged[0]), f"kkt={float(r1.kkt_err[0]):.2e}"
        np.testing.assert_allclose(
            np.asarray(r1.Z[0, -1, 0]), np.asarray(r0.Z[0, -1, 0]), atol=1e-3
        )

    def test_matches_cvx_reference(self):
        # unconstrained quadratic: compare against direct dense QP solution
        nlp = _double_integrator_nlp(T=8)
        solver = InteriorPointSolver(nlp, SolverOptions(tol=1e-10))
        res = solver.solve(jnp.asarray(nlp.z0)[None], max_iter=60)
        Z = np.asarray(res.Z[0])

        # dense QP: variables u_0..u_{T-2}; states determined by rollout
        T, dt = 8, 0.1
        nu = T - 1

        def states(u):
            x = np.zeros(T)
            v = np.zeros(T)
            for t in range(T - 1):
                x[t + 1] = x[t] + v[t] * dt
                v[t + 1] = v[t] + u[t] * dt
            return x, v

        # numerically minimize with scipy for ground truth
        from scipy.optimize import minimize

        def cost(u):
            x, v = states(u)
            return 0.5 * dt * np.sum(u**2) + 50 * (x[-1] - 1) ** 2 + 10 * v[-1] ** 2

        ref = minimize(cost, np.zeros(nu), method="BFGS", tol=1e-12)
        x_ref, v_ref = states(ref.x)
        np.testing.assert_allclose(Z[:, 0], x_ref, atol=1e-5)
        np.testing.assert_allclose(Z[:-1, 2], ref.x, atol=1e-4)


class TestOptionsAndStrategies:
    def test_option_enum_validation(self):
        import pytest

        with pytest.raises(ValueError, match="quasi_newton"):
            SolverOptions(quasi_newton="l-bfgs")
        with pytest.raises(ValueError, match="mu_strategy"):
            SolverOptions(mu_strategy="mehrotra")
        with pytest.raises(ValueError, match="kkt_backend"):
            SolverOptions(kkt_backend="lane")
        with pytest.raises(ValueError, match="eval_precision"):
            SolverOptions(eval_precision="bf16")

    def test_adaptive_mu_converges_to_same_optimum(self):
        # the LOQO centrality oracle (mu_strategy="adaptive") must reach the
        # same optimum as the monotone Fiacco-McCormick schedule on a
        # bound/inequality-constrained problem
        nlp = _double_integrator_nlp(u_bound=1.0, terminal_ineq=True)
        base = InteriorPointSolver(nlp, SolverOptions(tol=1e-8))
        res0 = base.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res0.converged[0])

        ada = InteriorPointSolver(
            nlp, SolverOptions(tol=1e-8, mu_strategy="adaptive")
        )
        res1 = ada.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res1.converged[0]), f"kkt_err={res1.kkt_err}"
        np.testing.assert_allclose(
            np.asarray(res1.Z[0, -1, 0]), np.asarray(res0.Z[0, -1, 0]),
            atol=1e-5,
        )

    def test_dtype_option_casts_state(self):
        nlp = _double_integrator_nlp()
        solver = InteriorPointSolver(
            nlp, SolverOptions(tol=1e-8, dtype="float32")
        )
        state = solver.init_state(jnp.asarray(nlp.z0, jnp.float64)[None])
        assert state.Z.dtype == jnp.float32

    def test_lanes_falls_back_to_xla_above_max_dim(self):
        # the kernel backend (kkt_backend="triton") covers stage tiles up
        # to 64: "auto" resolves to the XLA scan above that, and an explicit
        # kernel request above it is refused rather than rerouted
        d = 70
        T = 6

        def stage_cost(z, t):
            return 0.5 * jnp.sum(z**2)

        def pair_cost(zt, ztp1, t):
            return 0.0

        def terminal_cost(zT):
            return 0.5 * jnp.sum((zT - 1.0) ** 2)

        def defect(zt, ztp1, t):
            return ztp1 - zt - 0.1

        def ineq(z, t):
            return jnp.zeros((0,))

        nlp = StageNLP(
            T=T, d=d, s=d, m=0,
            stage_cost=stage_cost, pair_cost=pair_cost,
            terminal_cost=terminal_cost, defect=defect, ineq=ineq,
            lb=np.full((T, d), -np.inf), ub=np.full((T, d), np.inf),
            free_mask=np.ones((T, d), bool), z0=np.zeros((T, d)),
        )
        solver = InteriorPointSolver(
            nlp, SolverOptions(tol=1e-8, kkt_backend="auto", print_level=0)
        )
        assert solver.options.kkt_backend == "xla"
        res = solver.solve(jnp.asarray(nlp.z0)[None], max_iter=30)
        assert bool(res.converged[0])
        with pytest.raises(ValueError, match="stage dims"):
            InteriorPointSolver(nlp, SolverOptions(
                kkt_backend="triton", kkt_interpret=True, print_level=0
            ))

        # below the threshold the requested backend is kept
        small = _double_integrator_nlp()
        keep = InteriorPointSolver(
            small, SolverOptions(
                tol=1e-8, kkt_backend="triton", kkt_interpret=True
            )
        )
        assert keep.options.kkt_backend == "triton"

    def test_watchdog_inert_on_easy_problem_and_state_well_formed(self):
        # watchdog_trials > 0 with the filter line search must not change
        # the answer when the filter never rejects (the tentative-full-step
        # machinery stays dormant), and the watchdog state fields must exist
        nlp = _double_integrator_nlp(u_bound=1.0, terminal_ineq=True)
        base = InteriorPointSolver(
            nlp, SolverOptions(tol=1e-8, line_search="filter")
        )
        res0 = base.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res0.converged[0])

        wd = InteriorPointSolver(
            nlp,
            SolverOptions(tol=1e-8, line_search="filter", watchdog_trials=3),
        )
        state = wd.init_state(jnp.asarray(nlp.z0)[None])
        assert state.wd_count is not None and state.wd_Z is not None
        res1 = wd.solve(jnp.asarray(nlp.z0)[None], max_iter=80)
        assert bool(res1.converged[0]), f"kkt_err={res1.kkt_err}"
        np.testing.assert_allclose(
            np.asarray(res1.Z[0, -1, 0]), np.asarray(res0.Z[0, -1, 0]),
            atol=1e-6,
        )
