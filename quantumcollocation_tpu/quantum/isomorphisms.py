"""Real isomorphisms of complex quantum objects.

All solver-visible state is real. The layout decisions mirror the reference
framework's PiccoloQuantumObjects isomorphisms (see call sites in
/root/reference/src/trajectory_initialization.jl:40-41,413-419 and the numeric
fixture /root/reference/test/test_utils.jl:103 which pins the unitary iso-vec
layout to per-column [Re; Im] stacking):

- ket:       psi (N,) complex          -> [Re(psi); Im(psi)]           (2N,)
- unitary:   U (N,N) complex           -> columns of [Re(U); Im(U)]    (2N*N,)
             i.e. iso_vec[c*2N + r] = [Re U; Im U][r, c]
- density:   rho (N,N) complex         -> [Re(vec rho); Im(vec rho)]   (2N^2,)
             with column-major vec.

The Schroedinger generator isomorphism: d/dt psi = -i H psi becomes
d/dt psi_iso = G(H) psi_iso with G(H) = [[Im H, Re H], [-Re H, Im H]].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ket_to_iso",
    "iso_to_ket",
    "operator_to_iso_vec",
    "iso_vec_to_operator",
    "operator_to_iso_operator",
    "iso_operator_to_operator",
    "iso_vec_to_iso_operator",
    "iso_operator_to_iso_vec",
    "density_to_iso_vec",
    "iso_vec_to_density",
    "iso_G",
    "iso_D",
    "mat_to_iso",
]


def _xp(*arrays):
    """numpy for host (numpy/python) inputs, jnp for traced/device inputs.

    Build-time calls with numpy data stay on host (no device round trip for
    complex build-time arithmetic); traced calls use jnp as usual.
    """
    for a in arrays:
        if isinstance(a, (jax.Array, jax.core.Tracer)):
            return jnp
    return np


def ket_to_iso(psi):
    """Complex ket (N,) -> real iso vector (2N,) = [Re; Im]."""
    xp = _xp(psi)
    psi = xp.asarray(psi)
    return xp.concatenate([psi.real, psi.imag], axis=-1)


def iso_to_ket(psi_iso):
    """Real iso vector (2N,) -> complex ket (N,)."""
    xp = _xp(psi_iso)
    psi_iso = xp.asarray(psi_iso)
    n = psi_iso.shape[-1] // 2
    return psi_iso[..., :n] + 1j * psi_iso[..., n:]


def operator_to_iso_operator(U):
    """Complex (N, N) operator -> real (2N, N) iso operator [Re(U); Im(U)]."""
    xp = _xp(U)
    U = xp.asarray(U)
    return xp.concatenate([U.real, U.imag], axis=-2)


def iso_operator_to_operator(U_iso):
    """Real (2N, N) iso operator -> complex (N, N) operator."""
    xp = _xp(U_iso)
    U_iso = xp.asarray(U_iso)
    n = U_iso.shape[-2] // 2
    return U_iso[..., :n, :] + 1j * U_iso[..., n:, :]


def iso_operator_to_iso_vec(U_iso):
    """Real (2N, N) iso operator -> flat (2N*N,) iso vec (column-major stack)."""
    xp = _xp(U_iso)
    U_iso = xp.asarray(U_iso)
    return xp.swapaxes(U_iso, -1, -2).reshape(*U_iso.shape[:-2], -1)


def iso_vec_to_iso_operator(v):
    """Flat (2N*N,) iso vec -> real (2N, N) iso operator."""
    xp = _xp(v)
    v = xp.asarray(v)
    twoN2 = v.shape[-1]
    n = int(round((twoN2 / 2) ** 0.5))
    return xp.swapaxes(v.reshape(*v.shape[:-1], n, 2 * n), -1, -2)


def operator_to_iso_vec(U):
    """Complex (N, N) operator -> flat real (2N^2,) iso vec.

    Layout (matching the reference fixture): column c of U contributes the
    contiguous block [Re(U[:, c]); Im(U[:, c])] at offset c*2N.
    """
    return iso_operator_to_iso_vec(operator_to_iso_operator(U))


def iso_vec_to_operator(v):
    """Flat real (2N^2,) iso vec -> complex (N, N) operator."""
    return iso_operator_to_operator(iso_vec_to_iso_operator(v))


def density_to_iso_vec(rho):
    """Complex density matrix (N, N) -> real iso vec (2N^2,) = [Re vec; Im vec].

    Uses column-major vectorization so that superoperator actions are
    vec(A rho B) = kron(B.T, A) @ vec(rho).
    """
    xp = _xp(rho)
    rho = xp.asarray(rho)
    vec = xp.swapaxes(rho, -1, -2).reshape(*rho.shape[:-2], -1)
    return xp.concatenate([vec.real, vec.imag], axis=-1)


def iso_vec_to_density(v):
    """Real iso vec (2N^2,) -> complex density matrix (N, N)."""
    xp = _xp(v)
    v = xp.asarray(v)
    n2 = v.shape[-1] // 2
    n = int(round(n2**0.5))
    vec = v[..., :n2] + 1j * v[..., n2:]
    return xp.swapaxes(vec.reshape(*vec.shape[:-1], n, n), -1, -2)


def iso_G(H):
    """Hamiltonian -> real iso generator of -i H.

    G(H) = [[Im H, Re H], [-Re H, Im H]], so that with psi_iso = [Re; Im],
    (-i H psi) maps to G(H) @ psi_iso.  Unitary iso operators evolve as
    U_iso' = G(H) @ U_iso.
    """
    xp = _xp(H)
    H = xp.asarray(H)
    A, B = H.real, H.imag
    top = xp.concatenate([B, A], axis=-1)
    bot = xp.concatenate([-A, B], axis=-1)
    return xp.concatenate([top, bot], axis=-2)


def mat_to_iso(M):
    """General complex matrix -> real iso rep [[Re, -Im], [Im, Re]].

    This is the isomorphism for complex-linear action on [Re; Im] stacked
    vectors: (M v) maps to mat_to_iso(M) @ [Re v; Im v].
    """
    xp = _xp(M)
    M = xp.asarray(M)
    A, B = M.real, M.imag
    top = xp.concatenate([A, -B], axis=-1)
    bot = xp.concatenate([B, A], axis=-1)
    return xp.concatenate([top, bot], axis=-2)


def iso_D(H, dissipators):
    """Lindblad generator as a real iso superoperator (2N^2, 2N^2).

    d/dt vec_iso(rho) = iso_D(H, Ls) @ vec_iso(rho) with vec_iso as in
    `density_to_iso_vec` (column-major vec, [Re; Im] stacking), where
    L(rho) = -i[H, rho] + sum_k (L rho L^† - 1/2 {L^†L, rho}).
    """
    xp = _xp(H, *dissipators)
    H = xp.asarray(H)
    n = H.shape[-1]
    eye = xp.eye(n, dtype=H.dtype)
    S = -1j * (xp.kron(eye, H) - xp.kron(H.T, eye))
    for L in dissipators:
        L = xp.asarray(L)
        LdL = L.conj().T @ L
        S = S + (
            xp.kron(L.conj(), L)
            - 0.5 * xp.kron(eye, LdL)
            - 0.5 * xp.kron(LdL.T, eye)
        )
    return mat_to_iso(S)
