"""Analytic stage-dynamics assembly: defects, Jacobian blocks, and
Hessian-of-Lagrangian curvature from ONE propagator-bank evaluation.

The generic AD path (stage_nlp.make_nlp_functions) re-derives the matrix
exponential/Padé polynomials separately for the defect evaluation, the
Jacobian (d forward tangents), the Lagrangian gradient (a reverse pass), and
the Hessian (forward-over-reverse per nonlinear coordinate) — ~60% of each
IPM iteration.  This module exploits the known defect structure instead:

    exponential defect   F = u_{t+1} - (I ⊗ P(θ_t)) u_t,       θ = (a, Δt)
    implicit Padé defect F = (I ⊗ D(θ_t)) u_{t+1} - (I ⊗ N(θ_t)) u_t
                             with N = q(X), D = q(-X), X = G(a)Δt
    derivative defect    F = x_{t+1} - x_t - dx_t Δt_t          (bilinear)
    Δt-equality defect   F = Δt_{t+1} - Δt_t                    (linear)

so ALL solver-visible derivatives come from one bank per knot
(P, ∂P, ∂²P via dynamics.expm.expm_frechet_bank for exponential defects;
N, D and their directional derivatives via pade_poly_frechet for Padé),
plus constant-block assembly:

    A (∂F/∂z_t):   exp: state -(I⊗P), θ_k column -(∂P_k u_t)
                   padé: state -(I⊗N), θ_k column (∂D_k u_{t+1} - ∂N_k u_t)
    B (∂F/∂z_{t+1}): exp: identity; padé: +(I⊗D)
    Hessian-of-Lagrangian curvature of -λ·F:
      exp:  (θ_k,θ_l) ⟨∂²P_kl, Λu_t^T⟩;  (u_t,θ_k) ∂P_k^T Λ;  C-block 0
      padé: (θ_k,θ_l) ⟨∂²N_kl, Λu_t^T⟩ - ⟨∂²D_kl, Λu_{t+1}^T⟩;
            (u_t,θ_k) ∂N_k^T Λ;  C-block (θ_k, u_{t+1}) -∂D_k^T Λ
    plus the bilinear (dx, Δt) terms of derivative defects.

Role parity: the reference's QuantumDynamics sparse F/∂F/μ∂²F evaluators
(/root/reference/test/scripts/integrator_test_script.jl:41-52), redesigned
as a batched propagator bank instead of per-knot sparse assembly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..dynamics import integrators as igs
from ..dynamics.expm import (
    expm_frechet_bank,
    expm_squaring,
    frechet_pairs,
    pade_numerator_denominator,
    pade_poly_frechet,
)

__all__ = ["AnalyticStageDynamics", "build_analytic_dynamics"]


@dataclasses.dataclass(frozen=True)
class _PropGroup:
    """Integrators sharing one propagator bank: same system, controls,
    timestep source, integrator kind, and expm/Padé parameters."""

    kind: str  # "exp" | "pade"
    G_drift: Any  # (n, n) numpy
    G_drives: Any  # (na, n, n) numpy
    a_slice: tuple  # (a0, a1) control coords in the knot row
    dt_col: int | None  # timestep coord, or None (static dt)
    dt_static: float | None
    order: int
    num_squarings: int  # exp only
    members: tuple  # of (u0, u1, r0, r1, ncols)


@dataclasses.dataclass(frozen=True)
class _DerivRow:
    x0: int
    x1: int
    dx0: int
    dx1: int
    r0: int
    r1: int
    dt_col: int | None
    dt_static: float | None


@dataclasses.dataclass(frozen=True)
class _DtEqRow:
    c0: int
    c1: int
    r0: int
    r1: int


@dataclasses.dataclass(frozen=True)
class AnalyticStageDynamics:
    """Structured F/∂F/μ∂²F evaluators for a StageNLP (single instance;
    vmapped over the batch by the IPM).  Optionally operates in the scaled
    coordinates of scale_stage_nlp (var_scale/defect_scale)."""

    T: int
    d: int
    s: int
    groups: tuple  # of _PropGroup
    deriv_rows: tuple  # of _DerivRow
    dteq_rows: tuple  # of _DtEqRow
    var_scale: Any = None  # (d,) numpy or None
    defect_scale: Any = None  # (s,) numpy or None

    def with_scaling(self, var_scale, defect_scale):
        return dataclasses.replace(
            self,
            var_scale=np.asarray(var_scale),
            defect_scale=np.asarray(defect_scale),
        )

    # ------------------------------------------------------------------ #
    def _phys(self, Z):
        if self.var_scale is None:
            return Z
        return Z * jnp.asarray(self.var_scale, Z.dtype)

    def _dts(self, Zp, spec_col, spec_static):
        if spec_col is not None:
            return Zp[:-1, spec_col]
        return jnp.full((self.T - 1,), spec_static, Zp.dtype)

    def _directions(self, Zp, g: _PropGroup, *, second_order):
        """X = G(a)Δt and its θ-direction stacks for one group."""
        dtype = Zp.dtype
        Gd = jnp.asarray(g.G_drift, dtype)
        Gs = jnp.asarray(g.G_drives, dtype)
        a = Zp[:-1, g.a_slice[0]:g.a_slice[1]]  # (T-1, na)
        dts = self._dts(Zp, g.dt_col, g.dt_static)  # (T-1,)
        na = Gs.shape[0]
        G = Gd + jnp.tensordot(a, Gs, axes=1)  # (T-1, n, n)
        X = G * dts[:, None, None]

        free_dt = g.dt_col is not None
        K = na + (1 if free_dt else 0)
        dX_a = Gs[None] * dts[:, None, None, None]  # (T-1, na, n, n)
        dX = jnp.concatenate([dX_a, G[:, None]], axis=1) if free_dt else dX_a

        d2X = None
        if second_order and free_dt:
            # ∂²X only for the (a_j, Δt) pairs: constant G_j; zero otherwise
            pairs = frechet_pairs(K)
            rows = []
            for (k, l) in pairs:
                if k < na and l == na:
                    rows.append(np.asarray(g.G_drives)[k])
                else:
                    rows.append(np.zeros_like(np.asarray(g.G_drift)))
            d2X_const = jnp.asarray(np.stack(rows), dtype)
            d2X = jnp.broadcast_to(d2X_const, (self.T - 1, *d2X_const.shape))
        return X, dX, d2X, K, na

    def _bank(self, Zp, g: _PropGroup, *, first_order, second_order):
        """Propagator/polynomial bank for one group.

        exp:  (P,) or (P, dP, d2P)
        pade: (N, D) or (N, dN, d2N, D, dD, d2D)
        Leading axis T-1; derivative axes K (na [+ Δt]) / Kp pairs.
        """
        if not first_order:
            dtype = Zp.dtype
            Gd = jnp.asarray(g.G_drift, dtype)
            Gs = jnp.asarray(g.G_drives, dtype)
            a = Zp[:-1, g.a_slice[0]:g.a_slice[1]]
            dts = self._dts(Zp, g.dt_col, g.dt_static)
            G = Gd + jnp.tensordot(a, Gs, axes=1)
            X = G * dts[:, None, None]
            if g.kind == "exp":
                P = jax.vmap(
                    lambda x: expm_squaring(
                        x, order=g.order, num_squarings=g.num_squarings
                    )
                )(X)
                return (P,)
            Nm, Dm = jax.vmap(
                lambda x: pade_numerator_denominator(x, g.order)
            )(X)
            return (Nm, Dm)

        X, dX, d2X, K, na = self._directions(
            Zp, g, second_order=second_order
        )
        in_axes = (0, 0, 0 if d2X is not None else None)
        if g.kind == "exp":
            P, dP, d2P = jax.vmap(
                lambda x, dx, d2x: expm_frechet_bank(
                    x, dx, d2x,
                    order=g.order,
                    num_squarings=g.num_squarings,
                    second_order=second_order,
                ),
                in_axes=in_axes,
            )(X, dX, d2X)
            return (P, dP, d2P)
        Nm, dN, d2N, Dm, dD, d2D = jax.vmap(
            lambda x, dx, d2x: pade_poly_frechet(
                x, dx, d2x, order=g.order, second_order=second_order
            ),
            in_axes=in_axes,
        )(X, dX, d2X)
        return (Nm, dN, d2N, Dm, dD, d2D)

    @staticmethod
    def _umats(Zp, u0, u1, nrows):
        """State iso-vec slice -> (T, nrows, ncols) matrices (iso layout:
        index c*nrows + r, pinned by tests/test_quantum.py)."""
        ncols = (u1 - u0) // nrows
        return jnp.swapaxes(
            Zp[:, u0:u1].reshape(Zp.shape[0], ncols, nrows), -1, -2
        )

    @staticmethod
    def _vec(M):
        """(T', nrows, ncols) matrices -> (T', ncols*nrows) iso-vecs."""
        return jnp.swapaxes(M, -1, -2).reshape(M.shape[0], -1)

    # ------------------------------------------------------------------ #
    # F
    # ------------------------------------------------------------------ #
    def _defect_rows(self, Zp, banks):
        """(T-1, s) defect rows in PHYSICAL units."""
        Tm1 = self.T - 1
        F = jnp.zeros((Tm1, self.s), Zp.dtype)
        for g, bank in zip(self.groups, banks):
            nrows = g.G_drift.shape[0]
            for (u0, u1, r0, r1, ncols) in g.members:
                U = self._umats(Zp, u0, u1, nrows)  # (T, nrows, ncols)
                if g.kind == "exp":
                    P = bank[0]
                    resid = U[1:] - P @ U[:-1]
                else:
                    Nm = bank[0]
                    Dm = bank[1] if len(bank) == 2 else bank[3]
                    resid = Dm @ U[1:] - Nm @ U[:-1]
                F = F.at[:, r0:r1].set(self._vec(resid))
        for dr in self.deriv_rows:
            dts = self._dts(Zp, dr.dt_col, dr.dt_static)
            x = Zp[:, dr.x0:dr.x1]
            dx = Zp[:-1, dr.dx0:dr.dx1]
            F = F.at[:, dr.r0:dr.r1].set(x[1:] - x[:-1] - dx * dts[:, None])
        for er in self.dteq_rows:
            c = Zp[:, er.c0:er.c1]
            F = F.at[:, er.r0:er.r1].set(c[1:] - c[:-1])
        return F

    def defects(self, Z):
        Zp = self._phys(Z)
        banks = [
            self._bank(Zp, g, first_order=False, second_order=False)
            for g in self.groups
        ]
        F = self._defect_rows(Zp, banks)
        if self.defect_scale is not None:
            F = F * jnp.asarray(self.defect_scale, F.dtype)
        return F

    # ------------------------------------------------------------------ #
    # F + ∂F (+ bank aux for μ∂²F)
    # ------------------------------------------------------------------ #
    def dyn_eval(self, Z, *, second_order: bool):
        """Returns (F, A, B, aux): defects, Jacobian blocks (T-1, s, d), and
        the bank aux consumed by defect_curvature.  Scaled units."""
        Zp = self._phys(Z)
        Tm1, d, s = self.T - 1, self.d, self.s
        dtype = Z.dtype
        banks = [
            self._bank(Zp, g, first_order=True, second_order=second_order)
            for g in self.groups
        ]
        F = self._defect_rows(Zp, banks)

        A = jnp.zeros((Tm1, s, d), dtype)
        B = jnp.zeros((Tm1, s, d), dtype)

        for g, bank in zip(self.groups, banks):
            nrows = g.G_drift.shape[0]
            na = g.G_drives.shape[0]
            a0, a1 = g.a_slice
            for (u0, u1, r0, r1, ncols) in g.members:
                eye_c = jnp.eye(ncols, dtype=dtype)
                U = self._umats(Zp, u0, u1, nrows)  # (T, nrows, ncols)
                if g.kind == "exp":
                    P, dP, _ = bank
                    # θ columns: -(dP_k U_t), iso-vec'd over (c, i)
                    cols = -jnp.einsum("tkij,tjc->tkci", dP, U[:-1])
                    A_state, B_state = -P, None  # B: identity
                else:
                    Nm, dN, _, Dm, dD, _ = bank
                    cols = jnp.einsum(
                        "tkij,tjc->tkci", dD, U[1:]
                    ) - jnp.einsum("tkij,tjc->tkci", dN, U[:-1])
                    A_state, B_state = -Nm, Dm
                # state blocks: block-diagonal over columns c
                blk = jnp.einsum("cd,tij->tcidj", eye_c, A_state).reshape(
                    Tm1, ncols * nrows, ncols * nrows
                )
                A = A.at[:, r0:r1, u0:u1].set(blk)
                if B_state is None:
                    B = B.at[:, r0:r1, u0:u1].set(
                        jnp.eye(ncols * nrows, dtype=dtype)
                    )
                else:
                    blkB = jnp.einsum(
                        "cd,tij->tcidj", eye_c, B_state
                    ).reshape(Tm1, ncols * nrows, ncols * nrows)
                    B = B.at[:, r0:r1, u0:u1].set(blkB)
                cols = cols.reshape(Tm1, cols.shape[1], ncols * nrows)
                A = A.at[:, r0:r1, a0:a1].set(
                    jnp.swapaxes(cols[:, :na], -1, -2)
                )
                if g.dt_col is not None:
                    A = A.at[:, r0:r1, g.dt_col].set(cols[:, na])

        for dr in self.deriv_rows:
            k = dr.x1 - dr.x0
            eye_k = jnp.eye(k, dtype=dtype)
            dts = self._dts(Zp, dr.dt_col, dr.dt_static)
            A = A.at[:, dr.r0:dr.r1, dr.x0:dr.x1].set(-eye_k)
            A = A.at[:, dr.r0:dr.r1, dr.dx0:dr.dx1].set(
                -eye_k * dts[:, None, None]
            )
            if dr.dt_col is not None:
                A = A.at[:, dr.r0:dr.r1, dr.dt_col].set(
                    -Zp[:-1, dr.dx0:dr.dx1]
                )
            B = B.at[:, dr.r0:dr.r1, dr.x0:dr.x1].set(eye_k)

        for er in self.dteq_rows:
            k = er.c1 - er.c0
            eye_k = jnp.eye(k, dtype=dtype)
            A = A.at[:, er.r0:er.r1, er.c0:er.c1].set(-eye_k)
            B = B.at[:, er.r0:er.r1, er.c0:er.c1].set(eye_k)

        if self.defect_scale is not None:
            r = jnp.asarray(self.defect_scale, dtype)
            F = F * r
            A = A * r[None, :, None]
            B = B * r[None, :, None]
        if self.var_scale is not None:
            v = jnp.asarray(self.var_scale, dtype)
            A = A * v[None, None, :]
            B = B * v[None, None, :]

        aux = (Zp, banks)
        return F, A, B, aux

    # ------------------------------------------------------------------ #
    # μ∂²F (Hessian-of-Lagrangian defect-curvature contribution)
    # ------------------------------------------------------------------ #
    def defect_curvature(self, lam, aux):
        """Curvature of -λ·F at the point where aux was computed.  Returns
        (Hc (T, d, d), Cc (T-1, d, d)) in scaled units."""
        Zp, banks = aux
        Tm1, d = self.T - 1, self.d
        dtype = Zp.dtype
        lam_p = lam
        if self.defect_scale is not None:
            lam_p = lam * jnp.asarray(self.defect_scale, dtype)

        Hc = jnp.zeros((self.T, d, d), dtype)
        Cc = jnp.zeros((Tm1, d, d), dtype)

        for g, bank in zip(self.groups, banks):
            nrows = g.G_drift.shape[0]
            na = g.G_drives.shape[0]
            a0, a1 = g.a_slice
            free_dt = g.dt_col is not None
            K = na + (1 if free_dt else 0)
            pairs = frechet_pairs(K)
            theta_cols = list(range(a0, a1)) + ([g.dt_col] if free_dt else [])
            for (u0, u1, r0, r1, ncols) in g.members:
                U = self._umats(Zp, u0, u1, nrows)  # (T, nrows, ncols)
                Lam = jnp.swapaxes(
                    lam_p[:, r0:r1].reshape(Tm1, ncols, nrows), -1, -2
                )  # (T-1, nrows, ncols)
                if g.kind == "exp":
                    _, dP, d2P = bank
                    # (θ, θ): ⟨∂²P_kl, Λ u_t^T⟩
                    if d2P is not None:
                        W = jnp.einsum("trc,tsc->trs", Lam, U[:-1])
                        h = jnp.einsum("tpij,tij->tp", d2P, W)
                    else:
                        h = None
                    # (u_t, θ_k): ∂P_k^T Λ
                    m_t = jnp.einsum("tkrs,trc->tkcs", dP, Lam).reshape(
                        Tm1, K, ncols * nrows
                    )
                    m_tp1 = None
                else:
                    _, dN, d2N, _, dD, d2D = bank
                    if d2N is not None:
                        W_t = jnp.einsum("trc,tsc->trs", Lam, U[:-1])
                        W_tp1 = jnp.einsum("trc,tsc->trs", Lam, U[1:])
                        h = jnp.einsum("tpij,tij->tp", d2N, W_t) - jnp.einsum(
                            "tpij,tij->tp", d2D, W_tp1
                        )
                    else:
                        h = None
                    m_t = jnp.einsum("tkrs,trc->tkcs", dN, Lam).reshape(
                        Tm1, K, ncols * nrows
                    )
                    m_tp1 = -jnp.einsum("tkrs,trc->tkcs", dD, Lam).reshape(
                        Tm1, K, ncols * nrows
                    )

                if h is not None:
                    for p, (k, l) in enumerate(pairs):
                        ck, cl = theta_cols[k], theta_cols[l]
                        Hc = Hc.at[:-1, ck, cl].add(h[:, p])
                        if ck != cl:
                            Hc = Hc.at[:-1, cl, ck].add(h[:, p])
                Hc = Hc.at[:-1, u0:u1, a0:a1].add(
                    jnp.swapaxes(m_t[:, :na], -1, -2)
                )
                Hc = Hc.at[:-1, a0:a1, u0:u1].add(m_t[:, :na])
                if free_dt:
                    Hc = Hc.at[:-1, u0:u1, g.dt_col].add(m_t[:, na])
                    Hc = Hc.at[:-1, g.dt_col, u0:u1].add(m_t[:, na])
                if m_tp1 is not None:
                    # C-block: rows θ_k in z_t, cols u in z_{t+1}
                    Cc = Cc.at[:, a0:a1, u0:u1].add(m_tp1[:, :na])
                    if free_dt:
                        Cc = Cc.at[:, g.dt_col, u0:u1].add(m_tp1[:, na])

        for dr in self.deriv_rows:
            if dr.dt_col is None:
                continue
            lam_rows = lam_p[:, dr.r0:dr.r1]  # (T-1, k)
            idx = np.arange(dr.dx0, dr.dx1)
            Hc = Hc.at[:-1, idx, dr.dt_col].add(lam_rows)
            Hc = Hc.at[:-1, dr.dt_col, idx].add(lam_rows)

        if self.var_scale is not None:
            v = jnp.asarray(self.var_scale, dtype)
            Hc = Hc * v[None, :, None] * v[None, None, :]
            Cc = Cc * v[None, :, None] * v[None, None, :]
        return Hc, Cc


def build_analytic_dynamics(traj, integrators, d_aug: int):
    """Compile an integrator list into AnalyticStageDynamics, or return None
    if any integrator lacks an analytic assembly (AD fallback)."""
    T = traj.T
    tname = traj.timestep if isinstance(traj.timestep, str) else None

    def dt_spec(ig):
        name = getattr(ig, "timestep_name", None) or tname
        if name is not None and name in traj.components:
            return traj.components[name][0], None
        return None, float(traj.timestep)

    groups: dict = {}
    deriv_rows = []
    dteq_rows = []
    r0 = 0
    for ig in integrators:
        dim = ig.defect_dim(traj)
        r1 = r0 + dim
        kind = None
        if isinstance(
            ig,
            (
                igs.UnitaryExponentialIntegrator,
                igs.QuantumStateExponentialIntegrator,
            ),
        ):
            kind = "exp"
        elif isinstance(
            ig, (igs.UnitaryPadeIntegrator, igs.QuantumStatePadeIntegrator)
        ):
            kind = "pade"
        if kind is not None:
            u0, u1 = traj.components[ig.state_name]
            a0, a1 = traj.components[ig.control_name]
            dt_col, dt_static = dt_spec(ig)
            sysm = ig.system
            nsq = getattr(ig, "num_squarings", 0) or 0
            key = (kind, id(sysm), (a0, a1), dt_col, dt_static, ig.order, nsq)
            nrows = 2 * sysm.levels
            if (u1 - u0) % nrows != 0:
                return None
            ncols = (u1 - u0) // nrows
            member = (u0, u1, r0, r1, ncols)
            if key in groups:
                groups[key]["members"].append(member)
            else:
                groups[key] = dict(
                    kind=kind,
                    G_drift=np.asarray(sysm.G_drift),
                    G_drives=np.asarray(sysm.G_drives).reshape(
                        sysm.n_drives, nrows, nrows
                    ),
                    a_slice=(a0, a1),
                    dt_col=dt_col,
                    dt_static=dt_static,
                    order=ig.order,
                    num_squarings=nsq,
                    members=[member],
                )
        elif isinstance(ig, igs.DerivativeIntegrator):
            x0, x1 = traj.components[ig.x_name]
            dx0, dx1 = traj.components[ig.dx_name]
            dt_col, dt_static = dt_spec(ig)
            deriv_rows.append(
                _DerivRow(x0, x1, dx0, dx1, r0, r1, dt_col, dt_static)
            )
        elif isinstance(ig, igs.TimeStepEqualityIntegrator):
            c0, c1 = traj.components[ig.timestep_name]
            dteq_rows.append(_DtEqRow(c0, c1, r0, r1))
        else:
            return None  # density / robustness accumulator: AD fallback
        r0 = r1

    prop_groups = tuple(
        _PropGroup(
            kind=v["kind"],
            G_drift=v["G_drift"],
            G_drives=v["G_drives"],
            a_slice=v["a_slice"],
            dt_col=v["dt_col"],
            dt_static=v["dt_static"],
            order=v["order"],
            num_squarings=v["num_squarings"],
            members=tuple(v["members"]),
        )
        for v in groups.values()
    )
    return AnalyticStageDynamics(
        T=T,
        d=d_aug,
        s=r0,
        groups=prop_groups,
        deriv_rows=tuple(deriv_rows),
        dteq_rows=tuple(dteq_rows),
    )
