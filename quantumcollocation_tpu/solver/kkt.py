"""Block-tridiagonal KKT factorization and solve (stage-wise Riccati scan).

This replaces the reference stack's only native component — Ipopt's sparse
KKT factorization (MUMPS/HSL; /root/reference/README.md:93) — with a
structured factorization for the accelerator: the trajectory KKT system

    [ H̄_t      C_t        A_t^T ]
    [ C_t^T    H̄_{t+1}    B_t^T ]   (symmetric quasi-definite after
    [ A_t      B_t       -δ_c I ]    regularization)

is eliminated stage by stage.  Each elimination step is two small Cholesky
factorizations (d and s) plus a handful of small matmuls — a lax.scan over
knots, vmapped over thousands of batch instances.  (kkt_triton.py runs the
same elimination as one fused kernel per sweep.)  Quasi-definiteness (H̄ ≻ 0 via barrier + δ_w,
-δ_c I ≺ 0) guarantees the factorization exists without pivoting.

The factorization and the rhs solve are split (`factor_kkt` /
`solve_with_factors`) so a second rhs — Ipopt's second-order-correction
step, which reuses the iteration matrix with a corrected constraint rhs
(Wächter & Biegler 2006, step A-5.1) — costs only triangular solves and
matvecs, not a refactorization.

Single-instance shapes (the IPM vmaps over a leading batch axis):
    H  (T, d, d)    Lagrangian Hessian diagonal blocks (with barrier + reg)
    C  (T-1, d, d)  Hessian coupling blocks
    A  (T-1, s, d)  defect Jacobian wrt z_t
    B  (T-1, s, d)  defect Jacobian wrt z_{t+1}
    rz (T, d)       rhs for the z rows
    rnu (T-1, s)    rhs for the constraint rows

Solves  [[H̄, J^T], [J, -δ_c I]] [Δz; ν] = [rz; rnu]  and returns
(Δz, ν, ok);  Δλ = -ν for the IPM's sign convention.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = ["solve_kkt", "factor_kkt", "solve_with_factors", "KKTFactors"]


def _chol_solve(L, rhs):
    y = solve_triangular(L, rhs, lower=True)
    return solve_triangular(L.T, y, lower=False)


class KKTFactors(NamedTuple):
    """Stage-wise factorization of the block-tridiagonal saddle matrix.

    Stacked over t = 0..T-2 (plus the terminal factor); carries the
    constraint blocks so a re-solve needs only the new rhs.
    """

    L_P: Any  # (T-1, d, d) Cholesky of the eliminated primal blocks
    L_S: Any  # (T-1, s, s) Cholesky of the stage Schur complements
    X_A: Any  # (T-1, d, s) P^{-1} A^T
    G: Any  # (T-1, s, d)  A P^{-1} C - B
    L_final: Any  # (d, d)   Cholesky of the terminal block
    C: Any  # (T-1, d, d)
    A: Any  # (T-1, s, d)
    B: Any  # (T-1, s, d)


def factor_kkt(H, C, A, B, delta_c) -> KKTFactors:
    """Forward-eliminate the saddle matrix (no rhs). See module doc."""
    s = A.shape[1]
    eye_s = jnp.eye(s, dtype=H.dtype)

    def fwd_step(P, inp):
        H_next, C_t, A_t, B_t = inp
        L_P = jnp.linalg.cholesky(P)
        X_A = _chol_solve(L_P, A_t.T)  # (d, s)
        X_C = _chol_solve(L_P, C_t)  # (d, d)
        S = delta_c * eye_s + A_t @ X_A  # (s, s)
        L_S = jnp.linalg.cholesky(S)
        G = A_t @ X_C - B_t  # (s, d)
        P_next = H_next - C_t.T @ X_C + G.T @ _chol_solve(L_S, G)
        # symmetrize against drift
        P_next = 0.5 * (P_next + P_next.T)
        return P_next, (L_P, L_S, X_A, G)

    P_final, (L_Ps, L_Ss, X_As, Gs) = jax.lax.scan(
        fwd_step, H[0], (H[1:], C, A, B)
    )
    L_final = jnp.linalg.cholesky(P_final)
    return KKTFactors(L_Ps, L_Ss, X_As, Gs, L_final, C, A, B)


def solve_with_factors(fac: KKTFactors, rz, rnu):
    """Solve for a rhs given an existing factorization (triangular solves
    and matvecs only — the cheap path for second-order corrections)."""
    C, A, B = fac.C, fac.A, fac.B

    # ---- forward rhs elimination ------------------------------------------ #
    def fwd_step(q, inp):
        L_P, L_S, G, C_t, A_t, rz_next, rnu_t = inp
        x = _chol_solve(L_P, q)  # (d,)
        y = _chol_solve(L_S, A_t @ x - rnu_t)  # (s,)
        q_next = rz_next - C_t.T @ x + G.T @ y
        return q_next, q

    q_final, qs = jax.lax.scan(
        fwd_step, rz[0], (fac.L_P, fac.L_S, fac.G, C, A, rz[1:], rnu)
    )

    # ---- terminal solve --------------------------------------------------- #
    dz_last = _chol_solve(fac.L_final, q_final)

    # ---- backward substitution ------------------------------------------- #
    def bwd_step(dz_next, inp):
        L_P, L_S, X_A, q_t, C_t, A_t, B_t, rnu_t = inp
        u = q_t - C_t @ dz_next
        v = rnu_t - B_t @ dz_next
        x = _chol_solve(L_P, u)
        y = _chol_solve(L_S, A_t @ x - v)
        dz_t = x - X_A @ y
        return dz_t, (dz_t, y)

    inputs_bwd = (fac.L_P, fac.L_S, fac.X_A, qs, C, A, B, rnu)
    _, (dz_rest, nus) = jax.lax.scan(
        bwd_step, dz_last, inputs_bwd, reverse=True
    )
    dz = jnp.concatenate([dz_rest, dz_last[None]], axis=0)

    ok = jnp.all(jnp.isfinite(dz)) & jnp.all(jnp.isfinite(nus))
    return dz, nus, ok


def solve_kkt(H, C, A, B, rz, rnu, delta_c):
    """Factor + solve the block-tridiagonal saddle system. See module doc."""
    fac = factor_kkt(H, C, A, B, delta_c)
    return solve_with_factors(fac, rz, rnu)
