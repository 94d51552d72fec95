"""Matrix exponentials and propagators with static, jit-friendly structure.

The collocation hot path evaluates exp(G(a_t) * dt_t) for every knot t and
every batch instance.  jax.scipy.linalg.expm uses data-dependent norm-based
squaring — fine on CPU, but on an accelerator the dynamic control flow
blocks fusion.
Here the number of squarings is STATIC, derived at trace time from an upper
bound on ||G*dt|| (known from control bounds), so the whole propagator bank
compiles to a fixed chain of batched matmuls.

Padé coefficients follow the classic diagonal [m/m] approximant
exp(X) ≈ q_m(-X)^{-1} q_m(X), the same family the reference's
UnitaryPadeIntegrator uses for its implicit defects
(/root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:14,30,
README.md:79).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "pade_coefficients",
    "pade_numerator_denominator",
    "expm_pade",
    "expm_squaring",
    "default_num_squarings",
    "frechet_pairs",
    "pade_poly_frechet",
    "expm_frechet_bank",
]


def pade_coefficients(order: int):
    """Coefficients c_k of the [m/m] diagonal Padé numerator q_m(X) = sum c_k X^k.

    order = 2m is the accuracy order (matches the reference's `pade_order`
    convention: order 4 -> m=2, ..., order 20 -> m=10).
    """
    if order % 2 != 0:
        raise ValueError("pade order must be even")
    m = order // 2
    coeffs = []
    for k in range(m + 1):
        c = (
            math.factorial(2 * m - k)
            * math.factorial(m)
            / (
                math.factorial(2 * m)
                * math.factorial(k)
                * math.factorial(m - k)
            )
        )
        coeffs.append(c)
    return tuple(coeffs)


def _polyval_matrix(coeffs, X):
    """sum_k coeffs[k] X^k by Horner's rule (matrix argument)."""
    eye = jnp.eye(X.shape[-1], dtype=X.dtype)
    acc = coeffs[-1] * eye
    for c in reversed(coeffs[:-1]):
        acc = X @ acc + c * eye
    return acc


def pade_numerator_denominator(X, order: int = 4):
    """(A, B) with exp(X) ≈ B^{-1} A: A = q(X), B = q(-X)."""
    coeffs = pade_coefficients(order)
    num = _polyval_matrix(coeffs, X)
    den = _polyval_matrix(
        tuple(c * (-1.0) ** k for k, c in enumerate(coeffs)), X
    )
    return num, den


@partial(jax.jit, static_argnames=("order",))
def expm_pade(X, order: int = 8):
    """Single-step diagonal Padé approximant of exp(X) (no squaring)."""
    A, B = pade_numerator_denominator(X, order)
    return jnp.linalg.solve(B, A)


def default_num_squarings(norm_bound: float, order: int = 8) -> int:
    """Static squaring count s so that ||X|| / 2^s is inside the Padé sweet spot.

    For order-8 Padé, ||X||/2^s <= ~1.0 keeps the local error near machine
    epsilon in f32; we target 0.5 for margin.
    """
    if norm_bound <= 0.5:
        return 0
    return max(0, math.ceil(math.log2(norm_bound / 0.5)))


@partial(jax.jit, static_argnames=("order", "num_squarings"))
def expm_squaring(X, order: int = 8, num_squarings: int = 4):
    """exp(X) by scaling-and-squaring with a STATIC squaring count.

    All shapes/iteration counts are trace-time constants -> a fixed chain of
    batched matmuls, ideal for vmap over (batch, knots).
    """
    scale = 2.0 ** (-num_squarings)
    P = expm_pade(X * scale, order=order)
    for _ in range(num_squarings):
        P = P @ P
    return P


def frechet_pairs(K: int):
    """Canonical (k, l) pair ordering (k <= l) for second directional
    derivatives; index p of pair (k, l) matches expm_frechet_bank's d2P."""
    return tuple((k, l) for k in range(K) for l in range(k, K))


@partial(jax.jit, static_argnames=("order", "second_order"))
def pade_poly_frechet(X, dX, d2X=None, *, order: int = 4, second_order: bool = True):
    """Padé numerator/denominator N(X) = q(X), D(X) = q(-X) with first and
    second directional derivatives (same direction conventions as
    expm_frechet_bank; d2X=None means X is linear in θ).

    Returns (N, dN, d2N, D, dD, d2D) with dN (K, n, n), d2N (Kp, n, n) in
    frechet_pairs order; d2N/d2D are None when second_order=False.

    This is the derivative bank for the IMPLICIT Padé defect
    D(X) U_{t+1} - N(X) U_t = 0 (the reference's UnitaryPadeIntegrator,
    /root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:163-167)
    — polynomials only: no matrix inverse, no squaring.
    """
    n = X.shape[-1]
    K = dX.shape[0]
    pairs = frechet_pairs(K)
    Kp = len(pairs)
    dtype = X.dtype
    coeffs = pade_coefficients(order)
    eye = jnp.eye(n, dtype=dtype)
    if second_order and d2X is None:
        d2X = jnp.zeros((Kp, n, n), dtype)

    def horner(sign):
        acc = coeffs[-1] * eye
        dacc = jnp.zeros((K, n, n), dtype)
        d2acc = jnp.zeros((Kp, n, n), dtype) if second_order else None
        Xe = sign * X
        dXe = sign * dX
        for c in reversed(coeffs[:-1]):
            if second_order:
                d2acc_new = sign * d2X @ acc + Xe @ d2acc
                for p, (k, l) in enumerate(pairs):
                    d2acc_new = d2acc_new.at[p].add(
                        dXe[k] @ dacc[l] + dXe[l] @ dacc[k]
                    )
                d2acc = d2acc_new
            dacc = dXe @ acc + Xe @ dacc
            acc = Xe @ acc + c * eye
        return acc, dacc, d2acc

    N_m, dN, d2N = horner(1.0)
    D_m, dD, d2D = horner(-1.0)
    return N_m, dN, d2N, D_m, dD, d2D


@partial(jax.jit, static_argnames=("order", "num_squarings", "second_order"))
def expm_frechet_bank(
    X, dX, d2X=None, *, order: int = 8, num_squarings: int = 4,
    second_order: bool = True,
):
    """Propagator + directional derivatives in ONE scaling-and-squaring pass.

    For P(θ) = exp(X(θ)) with X (n, n) and K directions:
      dX  (K, n, n)   first-derivative directions  ∂X/∂θ_k
      d2X (Kp, n, n)  curvature directions ∂²X/∂θ_k∂θ_l in frechet_pairs(K)
                      order (None -> zero, i.e. X linear in θ)
    Returns (P, dP, d2P):
      P   (n, n)       exp(X)
      dP  (K, n, n)    ∂P/∂θ_k      (Fréchet derivative L_exp(X; dX_k))
      d2P (Kp, n, n)   ∂²P/∂θ_k∂θ_l (second directional derivative incl. the
                       X-curvature chain term), or None if second_order=False

    This is the analytic replacement for forward-over-reverse AD through the
    propagator: Horner/Gauss-solve/squaring recursions carry the derivative
    matrices alongside the primal (Al-Mohy & Higham's expm_frechet scheme,
    extended to second order).  Everything is a fixed chain of (n, n)
    matmuls — batched over knots/instances by vmap.

    Role parity: the reference's hot-path dynamics evaluators F/∂F/μ∂²F
    (/root/reference/test/scripts/integrator_test_script.jl:45-52).
    """
    K = dX.shape[0]
    pairs = frechet_pairs(K)
    scale = 2.0 ** (-num_squarings)

    Xs = X * scale
    dXs = dX * scale
    d2Xs = d2X * scale if (second_order and d2X is not None) else None

    N_m, dN, d2N, D_m, dD, d2D = pade_poly_frechet(
        Xs, dXs, d2Xs, order=order, second_order=second_order
    )

    # P0 = D^{-1} N and its derivatives (implicit differentiation of D P = N)
    Dinv = jnp.linalg.inv(D_m)
    P = Dinv @ N_m
    dP = Dinv @ (dN - dD @ P)
    if second_order:
        d2P = d2N - d2D @ P
        for p, (k, l) in enumerate(pairs):
            d2P = d2P.at[p].add(-dD[k] @ dP[l] - dD[l] @ dP[k])
        d2P = Dinv @ d2P

    for _ in range(num_squarings):
        if second_order:
            d2P_new = d2P @ P + P @ d2P
            for p, (k, l) in enumerate(pairs):
                d2P_new = d2P_new.at[p].add(dP[k] @ dP[l] + dP[l] @ dP[k])
            d2P = d2P_new
        dP = dP @ P + P @ dP
        P = P @ P

    return P, dP, (d2P if second_order else None)
