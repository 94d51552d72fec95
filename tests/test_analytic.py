"""Analytic propagator-bank assembly vs. the generic AD path.

The analytic path (solver/analytic.py) must reproduce the AD evaluators'
F/∂F/μ∂²F exactly — the same bar the reference sets for its QuantumDynamics
evaluators (dense finite-difference/structure checks,
/root/reference/test/test_utils.jl:14-27) — and full solves through either
path must land on the same optimum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import quantumcollocation_tpu as qct
from quantumcollocation_tpu.dynamics.expm import (
    expm_frechet_bank,
    expm_squaring,
    frechet_pairs,
    pade_numerator_denominator,
    pade_poly_frechet,
)
from quantumcollocation_tpu.solver.stage_nlp import make_nlp_functions


def _compare_functions(prob, atol=1e-9):
    nlp = prob.nlp
    assert nlp.analytic is not None, "analytic assembly was not built"
    nlp_ad = dataclasses.replace(nlp, analytic=None)
    f_an = make_nlp_functions(nlp, exact_hessian=True)
    f_ad = make_nlp_functions(nlp_ad, exact_hessian=True)
    rng = np.random.default_rng(1)
    Z = jnp.asarray(
        np.asarray(nlp.z0) + 0.05 * rng.standard_normal(nlp.z0.shape)
    )
    lam = jnp.asarray(rng.standard_normal((nlp.T - 1, nlp.s)))
    w = jnp.zeros((nlp.T, nlp.m))

    np.testing.assert_allclose(
        np.asarray(f_an.defects(Z)), np.asarray(f_ad.defects(Z)), atol=atol
    )
    A1, B1, Jg1 = f_an.jac_blocks(Z)
    A2, B2, Jg2 = f_ad.jac_blocks(Z)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A2), atol=atol)
    np.testing.assert_allclose(np.asarray(B1), np.asarray(B2), atol=atol)
    np.testing.assert_allclose(np.asarray(Jg1), np.asarray(Jg2), atol=atol)
    H1, C1 = f_an.hess_blocks(Z, lam, w)
    H2, C2 = f_ad.hess_blocks(Z, lam, w)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H2), atol=atol)
    np.testing.assert_allclose(np.asarray(C1), np.asarray(C2), atol=atol)
    # grad of the Lagrangian assembled from blocks == reverse AD
    gl_ad = f_ad.grad_lagrangian(Z, lam, w)
    jt = (
        jnp.zeros_like(gl_ad)
        .at[:-1].add(jnp.einsum("tsd,ts->td", A1, lam))
        .at[1:].add(jnp.einsum("tsd,ts->td", B1, lam))
    )
    gl_blocks = f_an.grad_cost(Z) - jt
    np.testing.assert_allclose(
        np.asarray(gl_blocks), np.asarray(gl_ad), atol=atol
    )


def _sys():
    return qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])


class TestBankMath:
    def test_expm_frechet_bank_matches_nested_ad(self):
        rng = np.random.default_rng(0)
        n = 4
        G0 = rng.standard_normal((n, n))
        Gs = rng.standard_normal((2, n, n))

        def X_of(theta):
            a, dt = theta[:2], theta[2]
            return (G0 + a[0] * Gs[0] + a[1] * Gs[1]) * dt

        theta0 = jnp.asarray([0.3, -0.5, 0.2])
        f = lambda th: expm_squaring(X_of(th), order=8, num_squarings=4)
        P_ad = f(theta0)
        dP_ad = jax.jacfwd(f)(theta0)
        d2P_ad = jax.jacfwd(jax.jacfwd(f))(theta0)

        X = X_of(theta0)
        G = G0 + theta0[0] * Gs[0] + theta0[1] * Gs[1]
        dX = jnp.stack([Gs[0] * theta0[2], Gs[1] * theta0[2], G])
        pairs = frechet_pairs(3)
        d2X = jnp.stack(
            [
                Gs[min(k, l)]
                if (l == 2 and k < 2)
                else jnp.zeros((n, n))
                for (k, l) in pairs
            ]
        )
        P, dP, d2P = expm_frechet_bank(X, dX, d2X, order=8, num_squarings=4)
        np.testing.assert_allclose(np.asarray(P), np.asarray(P_ad), atol=1e-12)
        for k in range(3):
            np.testing.assert_allclose(
                np.asarray(dP[k]), np.asarray(dP_ad[:, :, k]), atol=1e-12
            )
        for p, (k, l) in enumerate(pairs):
            np.testing.assert_allclose(
                np.asarray(d2P[p]), np.asarray(d2P_ad[:, :, k, l]), atol=1e-12
            )

    def test_pade_poly_frechet_matches_nested_ad(self):
        rng = np.random.default_rng(2)
        n = 4
        G0 = rng.standard_normal((n, n))
        G1 = rng.standard_normal((n, n))

        def X_of(theta):
            return (G0 + theta[0] * G1) * theta[1]

        theta0 = jnp.asarray([0.4, 0.3])
        fn = lambda th: pade_numerator_denominator(X_of(th), 4)[0]
        fd = lambda th: pade_numerator_denominator(X_of(th), 4)[1]
        X = X_of(theta0)
        G = G0 + theta0[0] * G1
        dX = jnp.stack([G1 * theta0[1], G])
        pairs = frechet_pairs(2)
        d2X = jnp.stack(
            [jnp.zeros((n, n)), G1, jnp.zeros((n, n))]
        )  # pairs (0,0), (0,1), (1,1)
        Nm, dN, d2N, Dm, dD, d2D = pade_poly_frechet(X, dX, d2X, order=4)
        np.testing.assert_allclose(np.asarray(Nm), np.asarray(fn(theta0)), atol=1e-12)
        np.testing.assert_allclose(np.asarray(Dm), np.asarray(fd(theta0)), atol=1e-12)
        d2N_ad = jax.jacfwd(jax.jacfwd(fn))(theta0)
        d2D_ad = jax.jacfwd(jax.jacfwd(fd))(theta0)
        for p, (k, l) in enumerate(pairs):
            np.testing.assert_allclose(
                np.asarray(d2N[p]), np.asarray(d2N_ad[:, :, k, l]), atol=1e-12
            )
            np.testing.assert_allclose(
                np.asarray(d2D[p]), np.asarray(d2D_ad[:, :, k, l]), atol=1e-12
            )


class TestAnalyticAssembly:
    def test_pade_free_time(self):
        _compare_functions(
            qct.UnitarySmoothPulseProblem(
                _sys(), qct.GATES["H"], 13, 0.2,
                piccolo_options=qct.PiccoloOptions(verbose=False),
                rng=np.random.default_rng(0),
            )
        )

    def test_exponential_free_time(self):
        _compare_functions(
            qct.UnitarySmoothPulseProblem(
                _sys(), qct.GATES["H"], 13, 0.2,
                piccolo_options=qct.PiccoloOptions(
                    verbose=False, integrator="exponential"
                ),
                rng=np.random.default_rng(0),
            )
        )

    def test_exponential_fixed_time(self):
        _compare_functions(
            qct.UnitarySmoothPulseProblem(
                _sys(), qct.GATES["H"], 13, 0.2,
                piccolo_options=qct.PiccoloOptions(
                    verbose=False, integrator="exponential", free_time=False
                ),
                rng=np.random.default_rng(0),
            )
        )

    def test_multi_state_shared_bank(self):
        prob = qct.QuantumStateSmoothPulseProblem(
            _sys(),
            [np.array([1, 0], dtype=complex), np.array([0, 1], dtype=complex)],
            [np.array([0, 1], dtype=complex), np.array([1, 0], dtype=complex)],
            13, 0.2,
            piccolo_options=qct.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(0),
        )
        # both state integrators share ONE propagator bank
        assert len(prob.nlp.analytic.groups) == 1
        assert len(prob.nlp.analytic.groups[0].members) == 2
        _compare_functions(prob)

    def test_ad_fallback_for_unsupported_integrators(self):
        # the density (Lindblad) integrator has no analytic assembly yet ->
        # the problem must fall back to the generic AD evaluators
        sys_open = qct.OpenQuantumSystem(
            qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]],
            [0.05 * np.asarray(qct.annihilate(2))],
        )
        prob = qct.DensityOperatorSmoothPulseProblem(
            sys_open,
            np.array([1, 0], dtype=complex),
            np.array([0, 1], dtype=complex),
            13, 0.2,
            piccolo_options=qct.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(0),
        )
        assert prob.nlp.analytic is None

    def test_solve_equivalence(self):
        # full solves through the analytic and AD paths reach the same optimum
        kw = dict(
            ipopt_options=qct.SolverOptions(print_level=1, tol=1e-7),
            rng=np.random.default_rng(0),
        )
        p_an = qct.UnitarySmoothPulseProblem(
            _sys(), qct.GATES["H"], 21, 0.2,
            piccolo_options=qct.PiccoloOptions(verbose=False), **kw,
        )
        p_ad = qct.UnitarySmoothPulseProblem(
            _sys(), qct.GATES["H"], 21, 0.2,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, jacobian_structure=False
            ),
            **kw,
        )
        assert p_an.nlp.analytic is not None and p_ad.nlp.analytic is None
        p_an.solve(max_iter=40)
        p_ad.solve(max_iter=40)
        assert bool(p_an.result.converged[0]) and bool(p_ad.result.converged[0])
        f_an = float(qct.unitary_rollout_fidelity(p_an.trajectory, _sys()))
        f_ad = float(qct.unitary_rollout_fidelity(p_ad.trajectory, _sys()))
        assert f_an > 0.85 and f_ad > 0.85  # the T=21/Q=100 NLP optimum
        np.testing.assert_allclose(f_an, f_ad, atol=1e-8)
        np.testing.assert_allclose(
            float(p_an.result.objective[0]),
            float(p_ad.result.objective[0]),
            rtol=1e-9,
        )


class TestBatchedAssembly:
    """The XLA assembly as the IPM runs it — dyn_eval + hess_blocks_aux
    vmapped over a batch, in the solver's SCALED units — against the
    generic nested-AD evaluators of the same scaled NLP."""

    def _check(self, prob, atol=1e-9):
        nlp = prob.solver.nlp
        assert nlp.analytic is not None
        f_an = make_nlp_functions(nlp, exact_hessian=True)
        f_ad = make_nlp_functions(
            dataclasses.replace(nlp, analytic=None), exact_hessian=True
        )
        B = 3
        rng = np.random.default_rng(3)
        Z = jnp.asarray(
            np.asarray(nlp.z0)[None]
            + 0.05 * rng.standard_normal((B, *nlp.z0.shape))
        )
        lam = jnp.asarray(rng.standard_normal((B, nlp.T - 1, nlp.s)))
        w = jnp.zeros((B, nlp.T, nlp.m))
        F, A, Bj, Jg, aux = jax.vmap(f_an.dyn_eval)(Z)
        H, C = jax.vmap(f_an.hess_blocks_aux)(Z, lam, w, aux)
        A2, B2, Jg2 = jax.vmap(f_ad.jac_blocks)(Z)
        H2, C2 = jax.vmap(f_ad.hess_blocks)(Z, lam, w)
        for got, ref in (
            (F, jax.vmap(f_ad.defects)(Z)), (A, A2), (Bj, B2), (Jg, Jg2),
            (H, H2), (C, C2),
        ):
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(ref), atol=atol
            )

    def test_exp_free_time(self):
        self._check(qct.UnitarySmoothPulseProblem(
            _sys(), qct.GATES["H"], 9, 0.2,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, integrator="exponential"
            ),
            rng=np.random.default_rng(0),
        ))

    def test_exp_fixed_time(self):
        self._check(qct.UnitarySmoothPulseProblem(
            _sys(), qct.GATES["H"], 9, 0.2,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, integrator="exponential", free_time=False
            ),
            rng=np.random.default_rng(0),
        ))

    def test_pade_free_time(self):
        self._check(qct.UnitarySmoothPulseProblem(
            _sys(), qct.GATES["H"], 9, 0.2,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, integrator="pade", pade_order=4
            ),
            rng=np.random.default_rng(0),
        ))

    def test_ket_pair_shared_bank(self):
        # two kets sharing one system/drive (multi-member group)
        psi0 = [np.array([1, 0], complex), np.array([0, 1], complex)]
        psi1 = [np.array([0, 1], complex), np.array([1, 0], complex)]
        self._check(qct.QuantumStateSmoothPulseProblem(
            _sys(), psi0, psi1, 9, 0.2,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, integrator="exponential"
            ),
            rng=np.random.default_rng(0),
        ))

    def test_batched_solve_matches_per_instance(self):
        # lockstep batching changes no instance: a batch of two solved
        # together lands on the iterates of each solved alone
        prob = qct.UnitarySmoothPulseProblem(
            _sys(), qct.GATES["H"], 11, 0.2, Q=100.0, R=1e-2,
            ipopt_options=qct.SolverOptions(print_level=1, tol=1e-6),
            piccolo_options=qct.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(0),
        )
        Z0 = prob.multistart_initial_decisions(
            2, sigma=0.05, rng=np.random.default_rng(4)
        )
        both = prob.solver.solve(jnp.asarray(Z0), max_iter=12)
        for b in range(2):
            one = prob.solver.solve(jnp.asarray(Z0[b:b + 1]), max_iter=12)
            np.testing.assert_allclose(
                np.asarray(both.Z[b]), np.asarray(one.Z[0]), atol=1e-9
            )
