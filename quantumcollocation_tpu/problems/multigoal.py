"""Multi-goal batched unitary synthesis: thousands of DIFFERENT target gates
solved in lockstep by ONE compiled IPM executable.

Design note (no reference counterpart — the reference solves one
problem per Ipopt invocation): for full-space unitary synthesis the goal can
be moved out of the objective and into per-instance *data* by the change of
variables

    W_t = U_t @ G†        (G the per-instance goal)

which leaves the dynamics invariant (W_{t+1} = Φ_t W_t), turns the objective
into infidelity against the IDENTITY (|tr(G† U_T)| = |tr(W_T)|), and moves
the goal into the pinned initial condition W_0 = G†.  Pinned coordinates
(free_mask=False) pass through each batch row of the initial decision tensor
untouched (solver/ipm.py init_state / step masking), so a single
XLA-compiled solve advances instances with arbitrary distinct goals — the
BASELINE config #5 workload (4096 seeds × randomized SU(4) goals) with no
per-goal recompilation and no extra KKT dimensions.

Objective/template surface mirrors UnitarySmoothPulseProblem
(/root/reference/src/problem_templates/unitary_smooth_pulse_problem.jl:70).
"""

from __future__ import annotations

import numpy as np

from ..quantum.isomorphisms import operator_to_iso_vec
from .unitary_smooth_pulse import UnitarySmoothPulseProblem

__all__ = [
    "UnitaryMultiGoalProblem",
    "multigoal_initial_decisions",
    "multigoal_rollout_fidelities",
    "random_su",
]


def random_su(n: int, rng) -> np.ndarray:
    """Haar-distributed SU(n) sample (QR of a complex Ginibre matrix with
    phase fixing)."""
    z = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, r = np.linalg.qr(z)
    q = q * (np.diagonal(r) / np.abs(np.diagonal(r))).conj()[None, :]
    det = np.linalg.det(q)
    return q * det ** (-1.0 / n)


def UnitaryMultiGoalProblem(system, T, dt, **kwargs):
    """Identity-goal UnitarySmoothPulseProblem whose batch rows carry their
    own goals via ``multigoal_initial_decisions``.  Accepts the full
    UnitarySmoothPulseProblem kwarg surface (embedded/subspace goals are not
    supported — the W = U G† change of variables needs a full-space goal)."""
    N = system.levels
    return UnitarySmoothPulseProblem(
        system, np.eye(N, dtype=complex), T, dt, **kwargs
    )


def multigoal_initial_decisions(
    prob,
    goals,
    *,
    n_seeds_per_goal: int = 1,
    sigma: float = 0.1,
    rng=None,
    unitary_name: str = "Ũ⃗",
    control_name: str = "a",
):
    """(len(goals)*n_seeds_per_goal, T, d) initial decisions.

    Per goal G, seed 0's unitary path is the geodesic from W_0 = G† to
    identity (the template's geodesic initialization after the change of
    variables, reference src/trajectory_initialization.jl:140-166); seeds > 0
    get sigma-perturbed controls with ROLLOUT-CONSISTENT states (the
    perturbed-controls rollout from W_0 = G†) so seeds start feasible in
    DIFFERENT basins — perturbing controls alone while sharing the geodesic
    state path collapses all seeds into one basin during feasibility
    restoration (same design as
    QuantumControlProblem.multistart_initial_decisions).  Instance
    b = goal_index * n_seeds_per_goal + seed_index.
    """
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla

    from ..dynamics.rollouts import unitary_rollout

    rng = rng or np.random.default_rng(0)
    traj = prob.trajectory
    T = traj.T
    z0 = np.asarray(prob.initial_decision(1))[0]
    u_sl = traj.comp_slice(unitary_name)
    a_sl = traj.comp_slice(control_name)

    B = len(goals) * n_seeds_per_goal
    rows = np.broadcast_to(z0, (B, *z0.shape)).copy()
    ts = np.linspace(0.0, 1.0, T)
    W0_iso = np.zeros((len(goals), u_sl.stop - u_sl.start))
    for gi, G in enumerate(goals):
        G = np.asarray(G, dtype=complex)
        W0 = G.conj().T
        W0_iso[gi] = np.asarray(operator_to_iso_vec(W0))
        # geodesic W_t = expm(t * logm(G)) @ G†  (W_T = I)
        H = sla.logm(G)
        path = np.stack(
            [np.asarray(operator_to_iso_vec(sla.expm(s * H) @ W0)) for s in ts]
        )
        lo = gi * n_seeds_per_goal
        rows[lo : lo + n_seeds_per_goal, :, u_sl] = path[None]
    # control perturbations (seed 0 of each goal stays clean)
    a = rows[:, :, a_sl]
    pert = sigma * rng.standard_normal(a[:, 1:-1].shape)
    mask = np.ones(B, dtype=bool)
    mask[:: n_seeds_per_goal] = False
    a[mask, 1:-1] += pert[mask]
    if control_name in traj.bounds:
        lo_b, hi_b = traj.bounds[control_name]
        a = np.clip(a, lo_b[None, None, :], hi_b[None, None, :])
    rows[:, :, a_sl] = a

    if n_seeds_per_goal > 1 and np.any(mask):
        dts = np.asarray(traj.get_timesteps(), dtype=np.float64)
        sysq = prob.system
        batched = jax.jit(
            jax.vmap(
                lambda v0, ai: unitary_rollout(v0, ai, jnp.asarray(dts), sysq)
            )
        )
        v0_rows = np.repeat(W0_iso, n_seeds_per_goal, axis=0)
        paths = np.asarray(
            batched(jnp.asarray(v0_rows[mask]), jnp.asarray(a[mask]))
        )
        rows_u = rows[:, :, u_sl]
        rows_u[mask] = paths
        rows[:, :, u_sl] = rows_u
    return rows


def multigoal_rollout_fidelities(
    prob,
    Z,
    goals,
    *,
    n_seeds_per_goal: int = 1,
    unitary_name: str = "Ũ⃗",
    control_name: str = "a",
):
    """Host-side float64 ground-truth validation: per instance, roll the
    controls forward under the true dynamics (eigh-based expm, f64) and
    score |tr(G† U_T)|/N against the instance's OWN goal.  Returns (B,)."""
    traj = prob.trajectory
    sysq = prob.system
    a_sl = traj.comp_slice(control_name)
    Z = np.asarray(Z, dtype=np.float64)
    B, T, _ = Z.shape
    a = Z[:, :, a_sl]
    tname = traj.timestep if isinstance(traj.timestep, str) else None
    if tname is not None:
        dt_sl = traj.comp_slice(tname)
        dts = Z[:, :, dt_sl][:, :, 0]
    else:
        dts = np.full((B, T), float(traj.timestep))

    H_drift = np.asarray(sysq.H_drift, dtype=complex)
    H_drives = np.stack([np.asarray(h, dtype=complex) for h in sysq.H_drives])
    N = H_drift.shape[0]

    # batched expm via eigh of the (B, T-1, N, N) Hermitian Hamiltonians
    H = H_drift[None, None] + np.einsum("btj,jkl->btkl", a[:, :-1], H_drives)
    w, V = np.linalg.eigh(H)
    phase = np.exp(-1j * w * dts[:, :-1, None])
    P = np.einsum("btij,btj,btkj->btik", V, phase, V.conj())

    U = np.broadcast_to(np.eye(N, dtype=complex), (B, N, N)).copy()
    for t in range(T - 1):
        U = P[:, t] @ U
    goals = np.asarray(goals, dtype=complex)
    Gd = np.repeat(goals.conj().transpose(0, 2, 1), n_seeds_per_goal, axis=0)
    return np.abs(np.einsum("bij,bji->b", Gd, U)) / N
