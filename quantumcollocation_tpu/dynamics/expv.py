"""Krylov (Arnoldi) action of the matrix exponential: exp(t A) b.

The reference's default rollout integrator is ExponentialAction.jl's `expv`
(/root/reference/src/trajectory_initialization.jl:398) — a matrix-free
action that never forms exp(tA).  This module provides the batched
equivalent for LARGE generators (composite/cat Hilbert spaces,
/root/reference/src/quantum_system_templates/cats.jl:9-53) where the dense
scaling-and-squaring propagator bank is prohibitive:

- `expv_krylov(t, A, b)`: Arnoldi projection onto a STATIC m-dimensional
  Krylov subspace (jit/scan friendly — no data-dependent shapes), dense
  expm on the small (m, m) Hessenberg matrix, optional time substeps for
  stiff generators.  `A` may be a matrix or a matvec callable, so Lindblad
  superoperators can be applied as O(N^3) complex matmuls instead of
  O(N^4)-sized dense superoperator rows (see
  OpenQuantumSystem.lindblad_action).

All arithmetic is real (iso representation) and runs under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["expv_krylov"]


def _arnoldi_expv_step(matvec, v, dt, m):
    """One substep: exp(dt*A) v by Arnoldi with a static m-dim basis.

    Static shapes: the basis V is (m, n) and H is (m+1, m); happy breakdown
    (lucky invariant subspaces) is handled by zeroing the spurious columns
    rather than early exit, which keeps the loop scan-compatible.
    """
    n = v.shape[0]
    dtype = v.dtype
    beta = jnp.linalg.norm(v)
    safe_beta = jnp.maximum(beta, jnp.finfo(dtype).tiny)
    V0 = jnp.zeros((m, n), dtype).at[0].set(v / safe_beta)
    H0 = jnp.zeros((m + 1, m), dtype)

    def body(carry, j):
        V, H = carry
        w = matvec(V[j])
        # modified Gram-Schmidt against all m rows; rows > j are zero so
        # the extra projections are no-ops (static-shape friendly)
        h = V @ w  # (m,)
        mask = jnp.arange(m) <= j
        h = jnp.where(mask, h, 0.0)
        w = w - h @ V
        # one reorthogonalization pass (classical DGKS) — cheap and keeps
        # the basis orthonormal enough for the small expm to be accurate
        h2 = V @ w
        h2 = jnp.where(mask, h2, 0.0)
        w = w - h2 @ V
        h = h + h2
        hnext = jnp.linalg.norm(w)
        H = H.at[:m, j].set(h).at[j + 1, j].set(hnext)
        w = jnp.where(
            hnext > 1e3 * jnp.finfo(dtype).eps,
            w / jnp.maximum(hnext, jnp.finfo(dtype).tiny),
            jnp.zeros_like(w),
        )
        V = jax.lax.cond(
            j + 1 < m,
            lambda Vv: Vv.at[j + 1].set(w),
            lambda Vv: Vv,
            V,
        )
        return (V, H), None

    (V, H), _ = jax.lax.scan(body, (V0, H0), jnp.arange(m))
    E = jax.scipy.linalg.expm(dt * H[:m, :m])
    y = beta * (E[:, 0] @ V)
    return y


def _expv_impl(t, A, b, m, substeps, matvec=None):
    # NOT jitted here: a closure matvec would defeat the jit cache; callers
    # jit the surrounding computation (rollout scans do)
    mv = matvec if matvec is not None else (lambda x: A @ x)
    dt = jnp.asarray(t, b.dtype) / substeps

    def sub(v, _):
        return _arnoldi_expv_step(mv, v, dt, m), None

    y, _ = jax.lax.scan(sub, b, None, length=substeps)
    return y


def expv_krylov(t, A, b, *, m: int = 24, substeps: int = 1, matvec=None):
    """exp(t*A) @ b without forming exp(t*A).

    Arnoldi-Krylov action (the ExponentialAction.jl `expv` analog for large
    Hilbert spaces; /root/reference/src/trajectory_initialization.jl:398).

    Args:
      t: scalar time.
      A: (n, n) matrix, or None when `matvec` is given.
      b: (n,) vector (real iso representation).
      m: static Krylov subspace dimension (accuracy knob; 24 reaches
         ~1e-12 for ||tA|| up to ~10 per substep).
      substeps: static number of time substeps for stiff generators
         (error ~ per-substep Krylov error x substeps).
      matvec: optional function v -> A v; use for operators too large to
         materialize (e.g. Lindblad superoperators via N x N matmuls).
    """
    b = jnp.asarray(b)
    if matvec is None:
        A = jnp.asarray(A)
        return _expv_impl(t, A, b, int(m), int(substeps))
    return _expv_impl(t, None, b, int(m), int(substeps), matvec=matvec)
