"""Fidelity functions in iso coordinates — pure REAL arithmetic.

Mirrors the reference surface: iso_fidelity, iso_vec_unitary_fidelity,
iso_vec_unitary_free_phase_fidelity (call sites:
/root/reference/src/problem_templates/unitary_minimum_time_problem.jl:77,88-90,
quantum_state_minimum_time_problem.jl:50).

Every function that can appear on the solver/objective path is implemented
in REAL arithmetic on the iso representations directly: no complex array is
ever materialized device-side, so these evaluate eagerly or under jit
without any complex device array.

Host (numpy) inputs stay on host via the `_xp` dispatch; traced/device
inputs use jnp.  Subspace restriction is a static index gather.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .isomorphisms import _xp, iso_vec_to_iso_operator


def _safe_abs(re, im, xp):
    """sqrt(re^2 + im^2) with a ZERO (sub)gradient at the origin.

    jnp.abs on complex numbers defines grad(|0|) = 0; a naive sqrt gives
    0.5/sqrt(0) * 0 = NaN, which poisons constraint Jacobians/Hessians at
    exactly-degenerate points (e.g. tr(H^† I) = 0 at the identity start of
    a Hadamard synthesis — a point every geodesic initialization contains).
    """
    sq = re**2 + im**2
    pos = sq > 0
    r = xp.sqrt(xp.where(pos, sq, 1.0))
    return xp.where(pos, r, 0.0)

__all__ = [
    "fidelity",
    "iso_fidelity",
    "unitary_fidelity",
    "iso_vec_unitary_fidelity",
    "iso_vec_unitary_free_phase_fidelity",
    "free_phase_iso_rotation",
    "density_pure_state_fidelity",
    "iso_vec_density_pure_state_fidelity",
]


def fidelity(psi, psi_goal):
    """|<psi_goal|psi>|^2 for complex kets (host-side convenience)."""
    psi = np.asarray(psi)
    psi_goal = np.asarray(psi_goal)
    return np.abs(np.vdot(psi_goal, psi)) ** 2


def iso_fidelity(psi_iso, psi_goal_iso):
    """|<goal|psi>|^2 for iso (real [Re; Im]) kets — real arithmetic only."""
    xp = _xp(psi_iso, psi_goal_iso)
    psi_iso = xp.asarray(psi_iso)
    psi_goal_iso = xp.asarray(psi_goal_iso)
    n = psi_iso.shape[-1] // 2
    pre, pim = psi_iso[..., :n], psi_iso[..., n:]
    gre, gim = psi_goal_iso[..., :n], psi_goal_iso[..., n:]
    # <goal|psi> = (gre - i gim) . (pre + i pim)
    re = xp.sum(gre * pre + gim * pim, axis=-1)
    im = xp.sum(gre * pim - gim * pre, axis=-1)
    return re**2 + im**2


def unitary_fidelity(U, U_goal, subspace=None):
    """F = |tr(U_goal^† U)| / n for complex operators (host-side convenience,
    optionally restricted to a subspace block)."""
    U = np.asarray(U)
    U_goal = np.asarray(U_goal)
    if subspace is not None:
        idx = np.asarray(subspace)
        U = U[..., idx[:, None], idx[None, :]]
        U_goal = U_goal[..., idx[:, None], idx[None, :]]
    n = U.shape[-1]
    tr = np.trace(np.swapaxes(U_goal.conj(), -1, -2) @ U, axis1=-2, axis2=-1)
    return np.abs(tr) / n


def _iso_vec_reim(v, subspace=None):
    """iso-vec (..., 2N^2) -> (Re U, Im U) real blocks, subspace-restricted."""
    xp = _xp(v)
    Uo = iso_vec_to_iso_operator(v)  # (..., 2N, N)
    n = Uo.shape[-1]
    Ure, Uim = Uo[..., :n, :], Uo[..., n:, :]
    if subspace is not None:
        idx = np.asarray(subspace)
        Ure = Ure[..., idx[:, None], idx[None, :]]
        Uim = Uim[..., idx[:, None], idx[None, :]]
    return xp.asarray(Ure), xp.asarray(Uim)


def iso_vec_unitary_fidelity(U_iso_vec, U_goal_iso_vec, subspace=None):
    """Unitary fidelity |tr(G^† U)|/n on iso-vec representations.

    Real arithmetic: tr(G^† U) = sum(Gre*Ure + Gim*Uim)
                               + i sum(Gre*Uim - Gim*Ure).
    """
    xp = _xp(U_iso_vec, U_goal_iso_vec)
    Ure, Uim = _iso_vec_reim(U_iso_vec, subspace)
    Gre, Gim = _iso_vec_reim(U_goal_iso_vec, subspace)
    n = Ure.shape[-1]
    re = xp.sum(Gre * Ure + Gim * Uim, axis=(-2, -1))
    im = xp.sum(Gre * Uim - Gim * Ure, axis=(-2, -1))
    return _safe_abs(re, im, xp) / n


def free_phase_iso_rotation(phases, phase_operators):
    """Real iso representation (2N, 2N) of R(phi) = exp(i sum_k phi_k G_k).

    With gen = sum_k phi_k (A_k + i B_k), i*gen has Re = -B̄, Im = Ā, and
    mat_to_iso(i*gen) = [[-B̄, -Ā], [Ā, -B̄]]; its real expm is the iso rep
    of R(phi) acting on [Re; Im]-stacked columns.  No complex arrays.
    """
    ops = (
        np.stack([np.asarray(op) for op in phase_operators])
        if isinstance(phase_operators, (list, tuple))
        else np.asarray(phase_operators)
    )
    A = np.ascontiguousarray(ops.real)
    B = np.ascontiguousarray(ops.imag)
    xp = _xp(phases)
    phases = xp.asarray(phases)
    dtype = phases.dtype
    Abar = xp.tensordot(phases, xp.asarray(A, dtype=dtype), axes=1)
    Bbar = xp.tensordot(phases, xp.asarray(B, dtype=dtype), axes=1)
    K = xp.concatenate(
        [
            xp.concatenate([-Bbar, -Abar], axis=-1),
            xp.concatenate([Abar, -Bbar], axis=-1),
        ],
        axis=-2,
    )
    if xp is np:
        import scipy.linalg

        return scipy.linalg.expm(K)
    from jax.scipy.linalg import expm as _expm

    return _expm(K)


def iso_vec_unitary_free_phase_fidelity(
    U_iso_vec, U_goal_iso_vec, phases, phase_operators, subspace=None
):
    """Fidelity up to optimizable global phases exp(i phi_k G_k).

    The achieved unitary is rotated by R(phi) before comparison:
    F = |tr(U_goal^† R(phi) U)| / n.  All real arithmetic.
    """
    xp = _xp(U_iso_vec, phases)
    R_iso = free_phase_iso_rotation(phases, phase_operators)  # (2N, 2N)
    Uo = iso_vec_to_iso_operator(xp.asarray(U_iso_vec))  # (2N, N)
    RU = R_iso @ Uo
    n = Uo.shape[-1]
    Ure, Uim = RU[..., :n, :], RU[..., n:, :]
    Go = iso_vec_to_iso_operator(xp.asarray(U_goal_iso_vec))
    Gre, Gim = Go[..., :n, :], Go[..., n:, :]
    if subspace is not None:
        idx = np.asarray(subspace)
        Ure = Ure[..., idx[:, None], idx[None, :]]
        Uim = Uim[..., idx[:, None], idx[None, :]]
        Gre = Gre[..., idx[:, None], idx[None, :]]
        Gim = Gim[..., idx[:, None], idx[None, :]]
        n = len(idx)
    re = xp.sum(Gre * Ure + Gim * Uim, axis=(-2, -1))
    im = xp.sum(Gre * Uim - Gim * Ure, axis=(-2, -1))
    return _safe_abs(re, im, xp) / n


def density_pure_state_fidelity(rho, psi_goal):
    """<psi|rho|psi> for a complex density matrix (host-side convenience)."""
    rho = np.asarray(rho)
    psi = np.asarray(psi_goal)
    return np.real(psi.conj() @ rho @ psi)


def iso_vec_density_pure_state_fidelity(rho_iso_vec, psi_goal):
    """<psi|rho|psi> directly on the iso-vec density — real arithmetic only.

    With column-major vec layout (density_to_iso_vec), rho_iso_vec[c*n + r]
    holds rho[r, c]; <psi|rho|psi> = sum_rc rho[r,c] * W[c,r] with
    W = psi psi^†, so the value is a real dot product against host-computed
    coefficient vectors.
    """
    psi = np.asarray(psi_goal, dtype=complex)
    n = psi.shape[-1]
    W = np.outer(psi, psi.conj())  # W[c, r] = psi_c psi*_r
    # coeff[c*n + r] = W[c, r] in the same column-major-of-rho order
    c_re = np.ascontiguousarray(W.real.reshape(-1))
    c_im = np.ascontiguousarray(W.imag.reshape(-1))
    xp = _xp(rho_iso_vec)
    v = xp.asarray(rho_iso_vec)
    n2 = n * n
    dtype = v.dtype
    re_part = xp.sum(v[..., :n2] * xp.asarray(c_re, dtype=dtype), axis=-1)
    im_part = xp.sum(v[..., n2:] * xp.asarray(c_im, dtype=dtype), axis=-1)
    return re_part - im_part
