"""Host-side f64 ground truth for batched solves.

Every device result is judged by rolling its controls out again on the
host in float64, independently of the solver's collocation state: the
final unitary is the time-ordered product of eigendecomposition
propagators exp(-i H(a_t) dt_t), compared with the goal by the
phase-insensitive gate fidelity |tr(G^† U)| / n (on a subspace where the
goal is embedded).
"""

from __future__ import annotations

import numpy as np

__all__ = ["extract_controls", "host_unitaries", "host_gate_fidelities"]


def extract_controls(prob, Z, control_name="a"):
    """(a (B, T, m), dts (B, T)) from a batch of solutions in problem
    units (IPMResult.Z, or InteriorPointSolver.unscale of a raw state)."""
    traj = prob.trajectory
    Z = np.asarray(Z, dtype=np.float64)
    a_all = Z[:, :, traj.comp_slice(control_name)]
    tname = traj.timestep if isinstance(traj.timestep, str) else None
    if tname is not None:
        dts_all = Z[:, :, traj.comp_slice(tname)][:, :, 0]
    else:
        dts_all = np.full(Z.shape[:2], float(traj.timestep))
    return a_all, dts_all


def host_unitaries(system, a_all, dts_all):
    """(B, N, N) final unitaries via batched eigh propagators, f64."""
    H_drift = np.asarray(system.H_drift, dtype=complex)
    H_drives = np.stack(
        [np.asarray(h, dtype=complex) for h in system.H_drives]
    )
    N = H_drift.shape[0]
    a = np.asarray(a_all, dtype=np.float64)
    dts = np.asarray(dts_all, dtype=np.float64)
    B, T = a.shape[0], a.shape[1]
    H = H_drift[None, None] + np.einsum("btj,jkl->btkl", a[:, :-1], H_drives)
    w, V = np.linalg.eigh(H)
    phase = np.exp(-1j * w * dts[:, : T - 1, None])
    P = np.einsum("btij,btj,btkj->btik", V, phase, V.conj())
    U = np.broadcast_to(np.eye(N, dtype=complex), (B, N, N)).copy()
    for t in range(T - 1):
        U = P[:, t] @ U
    return U


def host_gate_fidelities(system, a_all, dts_all, U_goal, subspace=None):
    """(B,) gate fidelities |tr(G^† U)| / n of the rolled-out controls;
    with `subspace`, both are restricted to those levels first."""
    U = host_unitaries(system, a_all, dts_all)
    G = np.asarray(U_goal, dtype=complex)
    if subspace is not None:
        idx = np.asarray(subspace)
        U = U[:, idx[:, None], idx[None, :]]
        G = G[idx[:, None], idx[None, :]] if G.shape[0] != len(idx) else G
    n = G.shape[0]
    return np.abs(np.einsum("ij,bji->b", G.conj().T, U)) / n
