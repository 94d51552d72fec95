"""Fused block-tridiagonal KKT sweeps as Pallas kernels on the Triton route.

The XLA path (kkt.py) eliminates the stage-wise saddle system with a
`lax.scan` over knots, vmapped over the batch: every knot is about ten tiny
batched linear-algebra operations (two Cholesky factorizations, triangular
solves, products), each its own device launch, repeated for every inertia
retry and re-solve.  Here ONE program per instance walks all knots in a
`fori_loop` with the Riccati carry in registers, so a factorization is one
launch for the whole batch instead of ~10 per knot.

Design (one program = one instance):
  - per-knot blocks are padded to power-of-two tiles (Triton's tensor shapes)
    of 16, 32 or 64 rows; padded diagonal entries are 1, padded couplings 0,
    so the padding never mixes into the real entries;
  - each stage block is factored as an INVERSE Cholesky factor
    L^{-1} (symmetric Gaussian elimination of [P | I] with a masked row loop),
    after which every solve is a product, run at full f32
    (precision HIGHEST — TF32 keeps ~3 digits, too few for the condensed
    KKT arithmetic);
  - the forward rhs elimination is fused into the factor sweep; the backward
    substitution is a second kernel; a rhs-only re-solve against kept
    factors (second-order corrections, iterative refinement) is the forward
    rhs kernel plus the backward kernel.

Right-hand sides carry r columns: rz (B, T, d[, r]), rnu (B, T-1, s[, r]).
One column runs as masked multiply-reduce matvecs; several columns (the
L-BFGS SMW correction's [rz | U]) are padded to >= 16 and run as products.

Numerics are the elimination of kkt.py with triangular solves replaced by
products with the inverse factors; validated in interpret mode against
`solve_kkt` and the f64 native oracle.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

__all__ = ["TritonFactors", "solve_kkt_triton", "resolve_kkt_triton",
           "tile_dim", "MAX_TILE"]

MAX_TILE = 64  # largest stage tile the kernels take
_HI = jax.lax.Precision.HIGHEST


def tile_dim(n: int) -> int:
    """Power-of-two tile (>= 16, Triton's smallest product dimension)."""
    t = 16
    while t < n:
        t *= 2
    return t


class TritonFactors(NamedTuple):
    """Kept factorization for rhs-only re-solves, batch-first.  The factors
    are padded to tiles and LP/LS/LPf are INVERSE Cholesky factors; the
    constraint blocks are the caller's unpadded ones."""

    LP: Any  # (B, T-1, Dp, Dp)
    LS: Any  # (B, T-1, Sp, Sp)
    XA: Any  # (B, T-1, Dp, Sp)  P^{-1} A^T
    G: Any  # (B, T-1, Sp, Dp)   A P^{-1} C - B
    LPf: Any  # (B, Dp, Dp)      terminal block
    C: Any  # (B, T-1, d, d)
    A: Any  # (B, T-1, s, d)
    B: Any  # (B, T-1, s, d)


# --------------------------------------------------------------------------- #
# in-kernel linear algebra on register tiles
# --------------------------------------------------------------------------- #
def _dot(a, b, ca, cb):
    return jax.lax.dot_general(
        a, b, (((ca,), (cb,)), ((), ())), precision=_HI,
        preferred_element_type=a.dtype,
    )


def _mm(a, b):
    return _dot(a, b, 1, 0)


def _mm_tn(a, b):
    """a^T b."""
    return _dot(a, b, 0, 0)


def _mm_nt(a, b):
    """a b^T."""
    return _dot(a, b, 1, 1)


def _mv(M, X):
    """M @ X for X (n, r): a product when r >= 16, else (r == 1) a masked
    multiply-reduce (Triton products need every dimension >= 16)."""
    if X.shape[1] >= 16:
        return _mm(M, X)
    return jnp.sum(M * jnp.squeeze(X, 1)[None, :], axis=1)[:, None]


def _mv_t(M, X):
    """M^T @ X."""
    if X.shape[1] >= 16:
        return _mm_tn(M, X)
    return jnp.sum(M * X, axis=0)[:, None]


def _inv_chol(P, n):
    """L^{-1} for P = L L^T (P SPD on its leading n x n block, identity
    beyond): symmetric Gaussian elimination of [P | I] row by row.  A
    non-positive pivot yields NaN/inf, which the caller's finiteness check
    reports as a failed factorization (as jnp.linalg.cholesky's NaNs do)."""
    D = P.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (D, D), 0)
    idx = jax.lax.broadcasted_iota(jnp.int32, (D,), 0)
    eye = (rows == jax.lax.broadcasted_iota(jnp.int32, (D, D), 1)).astype(
        P.dtype
    )

    def step(j, carry):
        Aw, E, dinv = carry
        # row j of the working matrix == column j on the trailing block
        rowA = jnp.sum(jnp.where(rows == j, Aw, 0.0), axis=0)
        rowA = jnp.where(idx >= j, rowA, 0.0)
        rowE = jnp.sum(jnp.where(rows == j, E, 0.0), axis=0)
        piv = jnp.sum(jnp.where(idx == j, rowA, 0.0))
        m = jnp.where(idx > j, rowA / piv, 0.0)
        Aw = Aw - m[:, None] * rowA[None, :]
        E = E - m[:, None] * rowE[None, :]
        dinv = jnp.where(idx == j, jax.lax.rsqrt(piv), dinv)
        return Aw, E, dinv

    _, E, dinv = jax.lax.fori_loop(
        0, n, step, (P, eye, jnp.ones((D,), P.dtype))
    )
    return dinv[:, None] * E


def _spd_solve(Li, X):
    """P^{-1} X given Li = L^{-1}."""
    return _mv_t(Li, _mv(Li, X))


# --------------------------------------------------------------------------- #
# kernels (grid = (batch,), one instance per program)
# --------------------------------------------------------------------------- #
def _factor_fwd_kernel(h_ref, c_ref, a_ref, b_ref, rz_ref, rnu_ref,
                       lp_ref, ls_ref, xa_ref, g_ref, lpf_ref, qs_ref,
                       *, d, s, delta_c):
    Tm1 = c_ref.shape[0]
    Sp = a_ref.shape[1]
    si = jax.lax.broadcasted_iota(jnp.int32, (Sp, Sp), 0)
    sj = jax.lax.broadcasted_iota(jnp.int32, (Sp, Sp), 1)
    # delta_c on the real diagonal, 1 on the padded one
    s_diag = jnp.where(
        si == sj, jnp.where(si < s, delta_c, 1.0), 0.0
    ).astype(a_ref.dtype)

    def knot(t, carry):
        P, q = carry
        Ct, At, Bt = c_ref[t], a_ref[t], b_ref[t]
        Li = _inv_chol(P, d)
        W = _mm_nt(Li, At)  # L^{-1} A^T
        V = _mm(Li, Ct)  # L^{-1} C
        S = s_diag + _mm_tn(W, W)
        LSi = _inv_chol(S, s)
        G = _mm_tn(W, V) - Bt
        Y = _mm(LSi, G)
        P_next = h_ref[t + 1] - _mm_tn(V, V) + _mm_tn(Y, Y)
        P_next = 0.5 * (P_next + P_next.T)
        XA = _mm_tn(Li, W)
        lp_ref[t] = Li
        ls_ref[t] = LSi
        xa_ref[t] = XA
        g_ref[t] = G
        # forward rhs elimination (same recursion as kkt.solve_with_factors)
        qs_ref[t] = q
        x = _spd_solve(Li, q)
        y = _spd_solve(LSi, _mv(At, x) - rnu_ref[t])
        q_next = rz_ref[t + 1] - _mv_t(Ct, x) + _mv_t(G, y)
        return P_next, q_next

    P_f, q_f = jax.lax.fori_loop(0, Tm1, knot, (h_ref[0], rz_ref[0]))
    lpf_ref[...] = _inv_chol(P_f, d)
    qs_ref[Tm1] = q_f


def _fwd_rhs_kernel(lp_ref, ls_ref, g_ref, c_ref, a_ref, rz_ref, rnu_ref,
                    qs_ref):
    Tm1 = c_ref.shape[0]

    def knot(t, q):
        Li, LSi = lp_ref[t], ls_ref[t]
        qs_ref[t] = q
        x = _spd_solve(Li, q)
        y = _spd_solve(LSi, _mv(a_ref[t], x) - rnu_ref[t])
        return rz_ref[t + 1] - _mv_t(c_ref[t], x) + _mv_t(g_ref[t], y)

    qs_ref[Tm1] = jax.lax.fori_loop(0, Tm1, knot, rz_ref[0])


def _bwd_kernel(lp_ref, ls_ref, xa_ref, lpf_ref, c_ref, a_ref, b_ref,
                qs_ref, rnu_ref, dz_ref, nu_ref):
    Tm1 = c_ref.shape[0]
    dz_last = _spd_solve(lpf_ref[...], qs_ref[Tm1])
    dz_ref[Tm1] = dz_last

    def knot(k, dz_next):
        t = Tm1 - 1 - k
        Li, LSi = lp_ref[t], ls_ref[t]
        u = qs_ref[t] - _mv(c_ref[t], dz_next)
        v = rnu_ref[t] - _mv(b_ref[t], dz_next)
        x = _spd_solve(Li, u)
        y = _spd_solve(LSi, _mv(a_ref[t], x) - v)
        dz_t = x - _mv(xa_ref[t], y)
        dz_ref[t] = dz_t
        nu_ref[t] = y
        return dz_t

    jax.lax.fori_loop(0, Tm1, knot, dz_last)


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #
def _num_warps(Dp):
    # the fastest of 1/2/4/8 warps per tile on an H100 (PERF.md):
    # d=15 -> 1, d=28 -> 4, d=47 -> 8
    return {16: 1, 32: 4}.get(Dp, 8)


def _call(kernel, ins, outs, Dp, interpret):
    """pallas_call over grid (batch,): every operand's whole per-instance
    slab is one block (its leading axis is the batch)."""

    def spec(shape):
        nd = len(shape) - 1
        return pl.BlockSpec(
            (None, *shape[1:]), lambda b, _nd=nd: (b,) + (0,) * _nd
        )

    Bt = ins[0].shape[0]
    return pl.pallas_call(
        kernel,
        grid=(Bt,),
        in_specs=[spec(x.shape) for x in ins],
        out_specs=[spec(o.shape) for o in outs],
        out_shape=outs,
        backend="triton",
        compiler_params=pltr.CompilerParams(
            num_warps=_num_warps(Dp), num_stages=1
        ),
        interpret=interpret,
    )(*ins)


def _pad_to(x, shape):
    return jnp.pad(x, [(0, n - m) for m, n in zip(x.shape, shape)])


def _pad_blocks(C, A, B, Dp, Sp):
    lead = C.shape[:2]
    return (_pad_to(C, lead + (Dp, Dp)), _pad_to(A, lead + (Sp, Dp)),
            _pad_to(B, lead + (Sp, Dp)))


def _rhs_cols(r):
    return 1 if r == 1 else max(16, 1 << (r - 1).bit_length())


def _pad_rhs(rz, rnu, Dp, Sp):
    """(B, T, d[, r]) / (B, T-1, s[, r]) -> padded (..., Dp|Sp, Rp)."""
    multi = rz.ndim == 4
    if not multi:
        rz, rnu = rz[..., None], rnu[..., None]
    r = rz.shape[-1]
    Rp = _rhs_cols(r)
    rz_p = _pad_to(rz, rz.shape[:2] + (Dp, Rp))
    rnu_p = _pad_to(rnu, rnu.shape[:2] + (Sp, Rp))
    return rz_p, rnu_p, multi, r


def _unpad_out(dz, nu, d, s, r, multi):
    dz, nu = dz[:, :, :d, :r], nu[:, :, :s, :r]
    if not multi:
        dz, nu = dz[..., 0], nu[..., 0]
    ok = jnp.isfinite(dz).reshape(dz.shape[0], -1).all(axis=1) & (
        jnp.isfinite(nu).reshape(nu.shape[0], -1).all(axis=1)
    )
    return dz, nu, ok


def _backward(LP, LS, XA, LPf, C, A, Bm, qs, rnu_p, Dp, interpret):
    Bt, Tm1, Sp = A.shape[0], A.shape[1], A.shape[2]
    Rp = qs.shape[-1]
    dt = qs.dtype
    return _call(
        _bwd_kernel, [LP, LS, XA, LPf, C, A, Bm, qs, rnu_p],
        [jax.ShapeDtypeStruct((Bt, Tm1 + 1, Dp, Rp), dt),
         jax.ShapeDtypeStruct((Bt, Tm1, Sp, Rp), dt)],
        Dp, interpret,
    )


def solve_kkt_triton(H, C, A, B, rz, rnu, delta_c, *, interpret=False,
                     want_factors=False):
    """Batched factor + solve.  Shapes as kkt.solve_kkt with a leading batch
    axis: H (B, T, d, d), C (B, T-1, d, d), A/B (B, T-1, s, d),
    rz (B, T, d[, r]), rnu (B, T-1, s[, r]).

    Returns (dz, nu, ok) — plus TritonFactors when want_factors."""
    Bt, T, d = H.shape[0], H.shape[1], H.shape[2]
    s = A.shape[2]
    Dp, Sp = tile_dim(d), tile_dim(s)
    if max(Dp, Sp) > MAX_TILE:
        raise ValueError(
            f"stage dims (d={d}, s={s}) exceed the Triton KKT tile limit "
            f"{MAX_TILE}; use kkt_backend='xla'"
        )
    dt = H.dtype
    pad_eye = jnp.diag((jnp.arange(Dp) >= d).astype(dt))
    H_p = _pad_to(H, (Bt, T, Dp, Dp)) + pad_eye
    C_p, A_p, B_p = _pad_blocks(C, A, B, Dp, Sp)
    rz_p, rnu_p, multi, r = _pad_rhs(rz, rnu, Dp, Sp)
    Rp = rz_p.shape[-1]
    kern = functools.partial(
        _factor_fwd_kernel, d=d, s=s, delta_c=float(delta_c)
    )
    LP, LS, XA, G, LPf, qs = _call(
        kern, [H_p, C_p, A_p, B_p, rz_p, rnu_p],
        [jax.ShapeDtypeStruct((Bt, T - 1, Dp, Dp), dt),
         jax.ShapeDtypeStruct((Bt, T - 1, Sp, Sp), dt),
         jax.ShapeDtypeStruct((Bt, T - 1, Dp, Sp), dt),
         jax.ShapeDtypeStruct((Bt, T - 1, Sp, Dp), dt),
         jax.ShapeDtypeStruct((Bt, Dp, Dp), dt),
         jax.ShapeDtypeStruct((Bt, T, Dp, Rp), dt)],
        Dp, interpret,
    )
    dz, nu = _backward(LP, LS, XA, LPf, C_p, A_p, B_p, qs, rnu_p, Dp,
                       interpret)
    out = _unpad_out(dz, nu, d, s, r, multi)
    if want_factors:
        return (*out, TritonFactors(LP, LS, XA, G, LPf, C, A, B))
    return out


def resolve_kkt_triton(fac: TritonFactors, rz, rnu, *, interpret=False):
    """rhs-only re-solve against kept factors (no refactorization)."""
    Dp, Sp = fac.LP.shape[-1], fac.LS.shape[-1]
    d, s = rz.shape[2], rnu.shape[2]
    rz_p, rnu_p, multi, r = _pad_rhs(rz, rnu, Dp, Sp)
    Bt, T, Rp = rz_p.shape[0], rz_p.shape[1], rz_p.shape[-1]
    C_p, A_p, B_p = _pad_blocks(fac.C, fac.A, fac.B, Dp, Sp)
    (qs,) = _call(
        _fwd_rhs_kernel,
        [fac.LP, fac.LS, fac.G, C_p, A_p, rz_p, rnu_p],
        [jax.ShapeDtypeStruct((Bt, T, Dp, Rp), rz_p.dtype)],
        Dp, interpret,
    )
    dz, nu = _backward(fac.LP, fac.LS, fac.XA, fac.LPf, C_p, A_p, B_p,
                       qs, rnu_p, Dp, interpret)
    return _unpad_out(dz, nu, d, s, r, multi)
