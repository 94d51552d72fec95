"""Compact limited-memory BFGS for the quasi-Newton IPM mode.

Replaces Ipopt's `hessian_approximation=limited-memory` (the solver mode the
reference exposes as `eval_hessian=false`, used via PiccoloOptions at
/root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:156-159):
the Lagrangian Hessian is approximated by the compact representation

    B = sigma*I - U M^{-1} U^T,      U = [Y, sigma*S]  (n, 2m)
    M = [[-D,  L^T       ],          D = diag(s_i^T y_i)
         [ L,  sigma*S^T S]]         L_ij = s_i^T y_j (i > j, chronological)

(Byrd, Nocedal & Schnabel 1994).  The block-tridiagonal KKT solve keeps the
sigma*I + barrier base (stage-diagonal, C=0) and applies the low-rank
correction by Sherman-Morrison-Woodbury with 2m extra triangular re-solves
of the SAME factorization — the structure-preserving alternative to densifying the
KKT system.

All functions are single-instance (the IPM vmaps over the batch); memory is
a chronological shift buffer (index m-1 = newest).  Invalid slots (fewer
than m accepted pairs) carry zero U columns and identity rows in M.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["lbfgs_update", "lbfgs_compact"]


def lbfgs_update(S, Y, sty, count, s, y, *, eps: float = 1e-8):
    """Insert the curvature pair (s, y) if it passes the positivity skip
    rule s^T y > eps * ||s||^2 (Ipopt's limited-memory safeguard).

    S, Y: (m, n);  sty: (m,);  count: scalar int32;  s, y: (n,).
    Returns (S, Y, sty, count, sigma, accepted) with sigma = y^Ty / s^Ty of
    the newest pair when accepted (the standard B0 scaling), else 0.
    """
    sy = jnp.dot(s, y)
    ss = jnp.dot(s, s)
    accept = sy > eps * jnp.maximum(ss, 1e-300)

    S_new = jnp.concatenate([S[1:], s[None]], axis=0)
    Y_new = jnp.concatenate([Y[1:], y[None]], axis=0)
    sty_new = jnp.concatenate([sty[1:], sy[None]], axis=0)

    S = jnp.where(accept, S_new, S)
    Y = jnp.where(accept, Y_new, Y)
    sty = jnp.where(accept, sty_new, sty)
    count = jnp.where(accept, jnp.minimum(count + 1, S.shape[0]), count)
    sigma = jnp.where(accept, jnp.dot(y, y) / jnp.maximum(sy, 1e-300), 0.0)
    return S, Y, sty, count, sigma, accept


def lbfgs_compact(S, Y, sty, count, sigma):
    """Build the compact-form pieces (U, M) for B = sigma*I - U M^{-1} U^T.

    S, Y: (m, n) chronological (newest last); sty: (m,); count: int32 valid
    pairs (the LAST `count` slots); sigma: scalar > 0.
    Returns U (n, 2m), M (2m, 2m) with invalid slots zeroed in U and set to
    identity rows/cols in M (so they contribute nothing).
    """
    m, n = S.shape
    idx = jnp.arange(m)
    valid = idx >= (m - count)  # (m,) newest `count` slots

    Sv = S * valid[:, None]
    Yv = Y * valid[:, None]

    SY = Sv @ Yv.T  # (m, m): SY[i, j] = s_i . y_j
    STS = Sv @ Sv.T
    L = jnp.tril(SY, k=-1)
    D = jnp.diag(jnp.where(valid, sty, 1.0))

    top = jnp.concatenate([-D, L.T], axis=1)
    bot = jnp.concatenate([L, sigma * STS], axis=1)
    M = jnp.concatenate([top, bot], axis=0)  # (2m, 2m)

    # identity rows/cols for invalid slots (keeps M invertible)
    valid2 = jnp.concatenate([valid, valid])
    mask = valid2[:, None] & valid2[None, :]
    M = jnp.where(mask, M, jnp.eye(2 * m, dtype=M.dtype))

    U = jnp.concatenate([Yv, sigma * Sv], axis=0).T  # (n, 2m)
    return U, M
