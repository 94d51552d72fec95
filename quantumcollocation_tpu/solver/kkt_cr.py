"""Block cyclic-reduction KKT solve — the parallel-in-T latency backend.

The Riccati scan in kkt.py is work-optimal for huge instance batches (every
scan step is a large batched matmul over B), but at B=1 its T sequential
stages leave the device idle: per-step matrices are ~30x30 and the critical
path is O(T) tiny kernels.  This backend restructures the SAME saddle
system as block cyclic reduction: pair each knot's primal row with its
defect-constraint row into one stage block

    w_t = [z_t; nu_t],   D_t = [[H_t, A_t^T], [A_t, -delta_c I]],
    U_t = [[C_t, 0], [B_t, 0]]   (coupling w_t -> w_{t+1})

giving a uniform block-tridiagonal system (the terminal stage is padded
with an identity dual block).  Cyclic reduction eliminates all odd stages
simultaneously — every level is ONE batched (n/2, m, m) inverse plus a
handful of batched matmuls — so the critical path is O(log T) large ops
instead of O(T) small ones.  Total FLOPs are ~2x the scan's; latency for a
single instance drops by ~T/log2(T) in depth.

Numerical safeguards (explicit block inverses are NOT backward-stable the
way the scan's quasi-definite Cholesky solves are, and late-barrier
Hessians span ~16 decades):
  * symmetric Ruiz equilibration of the stage system before reduction;
  * inertia verification via Haynsworth additivity — the eigendecomposed
    block eliminations count negative eigenvalues, whose total must be
    exactly (T-1)*s (Ipopt's LDL^T inertia test, Wächter & Biegler 2006
    step IC; an LU inverse would "succeed" on wrong-inertia systems and
    hand the IPM an ascent direction);
  * iterative refinement reusing the stored level inverses;
  * a residual gate on ok — an inaccurate solve reports failure and the
    IPM escalates delta_w, exactly as it does on a failed scan Cholesky.

This is the direct-collocation analog of parallel-in-time LQR (temporal
parallelization of the stage-wise factorization) and plays the role the
reference delegates to Ipopt's sparse multifrontal factorization
(/root/reference/README.md:93) when only one problem instance is in
flight (interactive / latency-critical use).

Cross-validated against the sequential-scan backend in
tests/test_kkt_cr.py.  It does ~2x the FLOPs of the scan, so its O(log T)
depth can only win at long horizons and small batches; on the H100 it is
not measured yet, and it is not the default anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["solve_kkt_cr"]


def _build_stages(H, C, A, B, rz, rnu, delta_c):
    """Assemble uniform (P, m, m) diagonal/coupling blocks and (P, m, K)
    rhs, padded to P = next power of two with decoupled identity stages."""
    T, d = H.shape[0], H.shape[1]
    s = A.shape[1]
    m = d + s
    dtype = H.dtype

    eye_s = jnp.eye(s, dtype=dtype)
    # diagonal blocks: [[H_t, A_t^T], [A_t, -delta_c I]] for t < T-1
    top = jnp.concatenate([H[:-1], jnp.swapaxes(A, 1, 2)], axis=2)
    bot = jnp.concatenate(
        [A, jnp.broadcast_to(-delta_c * eye_s, (T - 1, s, s))], axis=2
    )
    D = jnp.concatenate([top, bot], axis=1)  # (T-1, m, m)
    # terminal stage: [[H_{T-1}, 0], [0, I]] (dual slot is pure padding)
    D_last = jnp.zeros((m, m), dtype)
    D_last = D_last.at[:d, :d].set(H[-1]).at[d:, d:].set(eye_s)
    D = jnp.concatenate([D, D_last[None]], axis=0)  # (T, m, m)

    # coupling blocks U_t (t -> t+1): [[C_t, 0], [B_t, 0]]
    U = jnp.zeros((T, m, m), dtype)
    U = U.at[: T - 1, :d, :d].set(C).at[: T - 1, d:, :d].set(B)

    K = rz.shape[-1]
    r = jnp.zeros((T, m, K), dtype)
    r = r.at[:, :d, :].set(rz)
    r = r.at[: T - 1, d:, :].set(rnu)

    # pad the stage count to a power of two with decoupled identity stages
    P = 1 << int(T - 1).bit_length() if T > 1 else 1
    if P > T:
        pad = P - T
        eye_m = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (pad, m, m))
        D = jnp.concatenate([D, eye_m], axis=0)
        U = jnp.concatenate([U, jnp.zeros((pad, m, m), dtype)], axis=0)
        r = jnp.concatenate([r, jnp.zeros((pad, m, K), dtype)], axis=0)
    return D, U, r


def _shift_down(x):
    """Prepend a zero stage, drop the last: y[k] = x[k-1], y[0] = 0."""
    return jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)


def _shift_up(x):
    """y[k] = x[k+1], y[-1] = 0."""
    return jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)


def _ruiz_equilibrate(D, U, iters=3):
    """Symmetric Ruiz equilibration of the block-tridiagonal system.

    Returns per-(stage, row) scales sc (P, m) such that
    M' = S M S with S = diag(sc) has rows of ~unit max-norm.  Barrier-phase
    Hessians put ~1e8 bound terms next to ~1e-8 dual regularization on the
    SAME block diagonal; without equilibration the eigh-based block
    inverses lose ~all f32 (and most f64) accuracy.  Standard practice for
    symmetric indefinite KKT factorizations (HSL MC77 / MA57 auto-scaling).
    """
    sc = jnp.ones(D.shape[:2], D.dtype)
    for _ in range(iters):
        # row max-norm over the full block row: U_{t-1}^T | D_t | U_t
        rn = jnp.maximum(
            jnp.max(jnp.abs(D), axis=2),
            jnp.maximum(
                jnp.max(jnp.abs(U), axis=2),  # row i of U_t
                _shift_down(jnp.max(jnp.abs(U), axis=1)),  # col i of U_{t-1}
            ),
        )
        f = 1.0 / jnp.sqrt(jnp.maximum(rn, 1e-30))
        D = f[:, :, None] * D * f[:, None, :]
        U = f[:, :, None] * U * _shift_up(f)[:, None, :]
        sc = sc * f
    return D, U, sc


def _eigh_inv(D):
    """Batched symmetric inverse via eigh, plus the negative-eigenvalue
    count (for Haynsworth inertia accumulation)."""
    w, V = jnp.linalg.eigh(D)
    Dinv = (V * (1.0 / w)[..., None, :]) @ jnp.swapaxes(V, -1, -2)
    n_neg = jnp.sum(w < 0)
    return Dinv, n_neg


def _reduce(D, U):
    """Forward cyclic reduction of the matrix only.  Returns the per-level
    factors and the accumulated negative-eigenvalue count."""
    n_neg = jnp.zeros((), jnp.int32)
    levels = []
    while D.shape[0] > 1:
        D_e, D_o = D[0::2], D[1::2]
        U_e, U_o = U[0::2], U[1::2]
        Dinv_o, neg_o = _eigh_inv(D_o)  # (n/2, m, m) batched — one big op
        n_neg = n_neg + neg_o
        DiU_o = Dinv_o @ U_o  # Dinv[2k+1] U[2k+1]
        DiUT_e = Dinv_o @ jnp.swapaxes(U_e, 1, 2)  # Dinv[2k+1] U[2k]^T
        D_new = (
            D_e
            - _shift_down(jnp.swapaxes(U_o, 1, 2) @ DiU_o)
            - U_e @ DiUT_e
        )
        D_new = 0.5 * (D_new + jnp.swapaxes(D_new, 1, 2))
        U_new = -U_e @ DiU_o
        levels.append((Dinv_o, U_e, U_o))
        D, U = D_new, U_new
    Dinv_base, neg_base = _eigh_inv(D[0])
    n_neg = n_neg + neg_base
    return levels, Dinv_base, n_neg


def _rhs_solve(levels, Dinv_base, r):
    """Solve for one (multi-column) rhs against stored level factors:
    forward rhs elimination, base solve, parallel back substitution."""
    r_odds = []
    for Dinv_o, U_e, U_o in levels:
        r_e, r_o = r[0::2], r[1::2]
        Dir_o = Dinv_o @ r_o
        r = r_e - _shift_down(jnp.swapaxes(U_o, 1, 2) @ Dir_o) - U_e @ Dir_o
        r_odds.append(r_o)
    w = (Dinv_base @ r[0])[None]  # (1, m, K)
    for (Dinv_o, U_e, U_o), r_o in zip(reversed(levels), reversed(r_odds)):
        w_next = _shift_up(w)  # w[2k+2] aligned at k (zero past the end)
        w_o = Dinv_o @ (r_o - jnp.swapaxes(U_e, 1, 2) @ w - U_o @ w_next)
        n2 = w.shape[0]
        w_full = jnp.zeros((2 * n2,) + w.shape[1:], w.dtype)
        w = w_full.at[0::2].set(w).at[1::2].set(w_o)
    return w


def _tridiag_matvec(D, U, w):
    """Residual matvec of the block-tridiagonal system (fully parallel)."""
    return (
        D @ w
        + U @ _shift_up(w)
        + _shift_down(jnp.swapaxes(U, 1, 2)) @ _shift_down(w)
    )


def solve_kkt_cr(H, C, A, B, rz, rnu, delta_c, refine_iters=2):
    """Solve the block-tridiagonal saddle system by cyclic reduction.

    Same system and conventions as kkt.solve_kkt (module doc there):
      H (T, d, d), C (T-1, d, d), A (T-1, s, d), B (T-1, s, d),
      rz (T, d) or (T, d, K), rnu (T-1, s) or (T-1, s, K).
    Returns (dz, nu, ok) with dz (T, d[, K]), nu (T-1, s[, K]);
    ok = finite ∧ correct saddle inertia ∧ small refined residual.
    """
    single = rz.ndim == 2
    if single:
        rz = rz[..., None]
        rnu = rnu[..., None]
    T, d = H.shape[0], H.shape[1]
    s = A.shape[1]

    D, U, r = _build_stages(H, C, A, B, rz, rnu, delta_c)
    D, U, sc = _ruiz_equilibrate(D, U)
    r = sc[:, :, None] * r

    levels, Dinv_base, n_neg = _reduce(D, U)
    w = _rhs_solve(levels, Dinv_base, r)
    # iterative refinement against the equilibrated system (Ipopt refines
    # its KKT solves the same way); each pass reuses the stored inverses
    for _ in range(refine_iters):
        res = r - _tridiag_matvec(D, U, w)
        w = w + _rhs_solve(levels, Dinv_base, res)
    res = r - _tridiag_matvec(D, U, w)

    # residual gate: relative to the rhs, in the equilibrated scale where
    # ~unit rows make the threshold meaningful across the barrier range
    rnorm = jnp.max(jnp.abs(res))
    bnorm = jnp.maximum(jnp.max(jnp.abs(r)), 1e-30)
    # dtype-aware gate: 100*sqrt(eps) is fine in f64 (1.5e-6) but would
    # admit ~3% relative residual in f32; the barrier-phase conditioning
    # this backend's safeguards exist for demands a tighter f32 gate
    mult = 4.0 if w.dtype == jnp.float32 else 100.0
    tol = mult * jnp.sqrt(jnp.finfo(w.dtype).eps)
    ok_res = rnorm <= tol * bnorm

    w = sc[:, :, None] * w
    dz = w[:T, :d, :]
    nu = w[: T - 1, d:, :]
    if single:
        dz, nu = dz[..., 0], nu[..., 0]
    ok = (
        jnp.all(jnp.isfinite(dz))
        & jnp.all(jnp.isfinite(nu))
        & (n_neg == (T - 1) * s)  # Ipopt's inertia condition
        & ok_res
    )
    return dz, nu, ok
