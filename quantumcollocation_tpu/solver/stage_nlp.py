"""Stage-structured NLP intermediate representation + AD block assembly.

The trajectory NLP has stage-wise structure: variables z_t per knot couple
only to t±1 through defects F_t(z_t, z_{t+1}) and pair costs.  This module
defines the IR the problem templates compile into, and the batched AD
machinery that produces the block-tridiagonal KKT ingredients:

    H_t  (d,d)   Hessian of the Lagrangian, stage-diagonal blocks
    C_t  (d,d)   Hessian coupling blocks (z_t, z_{t+1})
    A_t  (s,d)   defect Jacobian wrt z_t
    B_t  (s,d)   defect Jacobian wrt z_{t+1}
    Jg_t (m,d)   inequality Jacobian

All derivatives are exact via JAX AD (the analytic-Jacobian/Hessian analog of
the reference's QuantumDynamics, /root/reference/test/scripts/
integrator_test_script.jl:41-52), evaluated for ALL knots in parallel with
vmap and fused by XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "StageNLP",
    "NLPFunctions",
    "make_nlp_functions",
    "scale_stage_nlp",
]


def scale_stage_nlp(nlp: "StageNLP", var_scale, defect_scale, ineq_scale, obj_scale):
    """Return a StageNLP in scaled coordinates ẑ = z / v.

    var_scale v: (d,) > 0;  defect_scale r: (s,);  ineq_scale q: (m,);
    obj_scale: scalar.  The scaled problem is
        min  s_obj * phi(v∘ẑ)   s.t.  r ∘ F(v∘ẑ..) = 0,  q ∘ g(v∘ẑ) >= 0,
        lb/v <= ẑ <= ub/v
    — Ipopt's gradient-based scaling generalized with Jacobian-column-norm
    variable scaling (equalizes curvature across e.g. stiff Δt columns).
    """
    v_all = np.asarray(var_scale)
    r_all = np.asarray(defect_scale)
    q_all = np.asarray(ineq_scale)
    s_obj = float(obj_scale)
    v_np = v_all

    # cast scale vectors to the evaluation dtype (a float64 constant would
    # silently promote float32 solver state under jax_enable_x64)
    def _v(z):
        return jnp.asarray(v_all, z.dtype)

    def stage_cost(z, t):
        return s_obj * nlp.stage_cost(_v(z) * z, t)

    def pair_cost(zt, ztp1, t):
        return s_obj * nlp.pair_cost(_v(zt) * zt, _v(ztp1) * ztp1, t)

    def terminal_cost(zT):
        return s_obj * nlp.terminal_cost(_v(zT) * zT)

    def defect(zt, ztp1, t):
        return jnp.asarray(r_all, zt.dtype) * nlp.defect(
            _v(zt) * zt, _v(ztp1) * ztp1, t
        )

    def ineq(z, t):
        return jnp.asarray(q_all, z.dtype) * nlp.ineq(_v(z) * z, t)

    return dataclasses.replace(
        nlp,
        stage_cost=stage_cost,
        pair_cost=pair_cost,
        terminal_cost=terminal_cost,
        defect=defect,
        ineq=ineq,
        lb=np.asarray(nlp.lb) / v_np[None, :],
        ub=np.asarray(nlp.ub) / v_np[None, :],
        z0=np.asarray(nlp.z0) / v_np[None, :],
        analytic=(
            nlp.analytic.with_scaling(v_all, r_all)
            if nlp.analytic is not None
            else None
        ),
    )


@dataclasses.dataclass
class StageNLP:
    """The stage-structured NLP.

    Callables (pure jax, single instance — batching is added by the IPM):
      stage_cost(z, t) -> scalar           cost summed over all T knots
      pair_cost(zt, ztp1, t) -> scalar     summed over t = 0..T-2
      terminal_cost(zT) -> scalar          terminal objective (globals live in
                                           the tail slots of z_{T-1})
      defect(zt, ztp1, t) -> (s,)          equality dynamics defects
      ineq(z, t) -> (m,)                   inequality constraints g >= 0
                                           (inactive rows return +1.0)

    Static data:
      T, d, s, m : sizes
      lb, ub     : (T, d) bounds with ±inf for unbounded
      free_mask  : (T, d) bool; False = variable pinned to its z0 value
      z0         : (T, d) initial guess
    """

    T: int
    d: int
    s: int
    m: int
    stage_cost: Callable
    pair_cost: Callable
    terminal_cost: Callable
    defect: Callable
    ineq: Callable
    lb: Any
    ub: Any
    free_mask: Any
    z0: Any
    # indices (into a knot row z_t) where defects are NONLINEAR; everything
    # else enters F linearly.  When provided, the expensive defect-curvature
    # Hessian is computed with forward passes over only these coordinates
    # (controls + timestep for exp/Padé defects) instead of all 2d.
    nl_coords: Any = None
    # structured F/∂F/μ∂²F evaluators (solver.analytic.AnalyticStageDynamics)
    # built from the integrator list; None -> generic AD assembly
    analytic: Any = None


@dataclasses.dataclass
class NLPFunctions:
    """Vmapped whole-trajectory callables derived from a StageNLP."""

    total_cost: Callable  # (T,d) -> scalar
    defects: Callable  # (T,d) -> (T-1, s)
    ineqs: Callable  # (T,d) -> (T, m)
    grad_lagrangian: Callable  # (Z, lam, w) -> (T, d)
    hess_blocks: Callable  # (Z, lam, w) -> H (T,d,d), C (T-1,d,d)
    jac_blocks: Callable  # (Z) -> A (T-1,s,d), B (T-1,s,d), Jg (T,m,d)
    # fused per-iteration API (used by the IPM hot loop):
    grad_cost: Callable  # (Z) -> (T, d)  gradient of costs ONLY (no J^T λ)
    dyn_eval: Callable  # (Z) -> (F, A, B, Jg, aux) in one pass
    hess_blocks_aux: Callable  # (Z, lam, w, aux) -> (H, C), reusing aux


def make_nlp_functions(nlp: StageNLP, *, exact_hessian: bool = True) -> NLPFunctions:
    T, d, s, m = nlp.T, nlp.d, nlp.s, nlp.m
    ts = jnp.arange(T)
    ts_pair = jnp.arange(T - 1)

    def total_cost(Z):
        stage = jnp.sum(jax.vmap(nlp.stage_cost)(Z, ts))
        pair = jnp.sum(jax.vmap(nlp.pair_cost)(Z[:-1], Z[1:], ts_pair))
        return stage + pair + nlp.terminal_cost(Z[-1])

    def defects(Z):
        return jax.vmap(nlp.defect)(Z[:-1], Z[1:], ts_pair)

    def ineqs(Z):
        if m == 0:
            return jnp.zeros((T, 0), dtype=Z.dtype)
        return jax.vmap(nlp.ineq)(Z, ts)

    def lagrangian(Z, lam, w):
        val = total_cost(Z) - jnp.sum(lam * defects(Z))
        if m > 0:
            val = val - jnp.sum(w * ineqs(Z))
        return val

    grad_lagrangian = jax.grad(lagrangian, argnums=0)

    # ---- Hessian blocks -------------------------------------------------- #
    def _stage_lag(z, t, w_t):
        val = nlp.stage_cost(z, t)
        if m > 0:
            val = val - w_t @ nlp.ineq(z, t)
        return val

    def _pair_lag(zz, t, lam_t):
        zt, ztp1 = zz[:d], zz[d:]
        val = nlp.pair_cost(zt, ztp1, t)
        val = val - lam_t @ nlp.defect(zt, ztp1, t)
        return val

    stage_hess = jax.vmap(jax.hessian(_stage_lag, argnums=0))
    term_hess = jax.hessian(nlp.terminal_cost)

    nl = (
        np.asarray(nlp.nl_coords, dtype=np.int32)
        if nlp.nl_coords is not None
        else None
    )
    if nl is not None and 0 < len(nl) < d:
        # structured pair Hessian: defects are linear in all coords except
        # nl (and always linear in z_{t+1}), so the lam^T F curvature has
        # support only on rows/cols in nl — n_nl forward passes instead of 2d
        def _pc(zz, t):
            return nlp.pair_cost(zz[:d], zz[d:], t)

        pc_hess = jax.vmap(jax.hessian(_pc, argnums=0))

        def _lamF(zz, t, lam_t):
            return -lam_t @ nlp.defect(zz[:d], zz[d:], t)

        g_lamF = jax.grad(_lamF, argnums=0)
        nl_j = jnp.asarray(nl)

        def _pair_curv(zz, t, lam_t):
            def g_of_v(v):
                return g_lamF(zz.at[nl_j].set(v), t, lam_t)

            cols = jax.jacfwd(g_of_v)(zz[nl_j])  # (2d, n_nl)
            Hc = jnp.zeros((2 * d, 2 * d), zz.dtype)
            Hc = Hc.at[:, nl_j].set(cols)
            Hc = Hc.at[nl_j, :].set(cols.T)
            return Hc

        pair_curv = jax.vmap(_pair_curv)

        def pair_hess(zz, ts_p, lam):
            return pc_hess(zz, ts_p) + pair_curv(zz, ts_p, lam)

    else:
        pair_hess = jax.vmap(jax.hessian(_pair_lag, argnums=0))

    def _gn_pair_cost_hess():
        # Gauss-Newton mode: drop the lam^T F curvature (quasi-Newton analog
        # of the reference's eval_hessian=false path)
        def _pc(zz, t):
            return nlp.pair_cost(zz[:d], zz[d:], t)

        return jax.vmap(jax.hessian(_pc, argnums=0))

    gn_pair_hess = _gn_pair_cost_hess()

    def _cost_hess(Z, w):
        """Cost(+inequality) Hessian blocks — no defect curvature."""
        zz = jnp.concatenate([Z[:-1], Z[1:]], axis=1)  # (T-1, 2d)
        Hp = gn_pair_hess(zz, ts_pair)
        w_arg = w if m > 0 else jnp.zeros((T, 0), dtype=Z.dtype)
        Hs = stage_hess(Z, ts, w_arg)  # (T, d, d)
        Ht = term_hess(Z[-1])  # (d, d)
        H = Hs
        H = H.at[:-1].add(Hp[:, :d, :d])
        H = H.at[1:].add(Hp[:, d:, d:])
        H = H.at[-1].add(Ht)
        C = Hp[:, :d, d:]  # (T-1, d, d)
        return H, C

    def hess_blocks(Z, lam, w):
        if nlp.analytic is not None:
            H, C = _cost_hess(Z, w)
            if exact_hessian:
                _, _, _, aux = nlp.analytic.dyn_eval(
                    Z, second_order=True
                )
                Hc, Cc = nlp.analytic.defect_curvature(lam, aux)
                H, C = H + Hc, C + Cc
            return H, C
        zz = jnp.concatenate([Z[:-1], Z[1:]], axis=1)  # (T-1, 2d)
        if exact_hessian:
            Hp = pair_hess(zz, ts_pair, lam)  # (T-1, 2d, 2d)
        else:
            Hp = gn_pair_hess(zz, ts_pair)
        w_arg = w if m > 0 else jnp.zeros((T, 0), dtype=Z.dtype)
        Hs = stage_hess(Z, ts, w_arg)  # (T, d, d)
        Ht = term_hess(Z[-1])  # (d, d)

        H = Hs
        H = H.at[:-1].add(Hp[:, :d, :d])
        H = H.at[1:].add(Hp[:, d:, d:])
        H = H.at[-1].add(Ht)
        C = Hp[:, :d, d:]  # (T-1, d, d)
        return H, C

    # ---- constraint Jacobian blocks -------------------------------------- #
    jac_A = jax.vmap(jax.jacfwd(nlp.defect, argnums=0))
    jac_B = jax.vmap(jax.jacfwd(nlp.defect, argnums=1))
    jac_g = jax.vmap(jax.jacfwd(nlp.ineq, argnums=0)) if m > 0 else None

    def _jac_g_full(Z):
        if m > 0:
            return jac_g(Z, ts)
        return jnp.zeros((T, 0, d), dtype=Z.dtype)

    def jac_blocks(Z):
        if nlp.analytic is not None:
            _, A, B, _ = nlp.analytic.dyn_eval(Z, second_order=False)
            return A, B, _jac_g_full(Z)
        A = jac_A(Z[:-1], Z[1:], ts_pair)
        B = jac_B(Z[:-1], Z[1:], ts_pair)
        return A, B, _jac_g_full(Z)

    # ---- fused per-iteration evaluation ----------------------------------- #
    grad_cost = jax.grad(total_cost)

    def dyn_eval(Z):
        """(F, A, B, Jg, aux) in ONE propagator-bank pass (analytic) or via
        the generic AD evaluators (aux=None)."""
        if nlp.analytic is not None:
            F, A, B, aux = nlp.analytic.dyn_eval(
                Z, second_order=exact_hessian
            )
            return F, A, B, _jac_g_full(Z), aux
        F = defects(Z)
        A = jac_A(Z[:-1], Z[1:], ts_pair)
        B = jac_B(Z[:-1], Z[1:], ts_pair)
        return F, A, B, _jac_g_full(Z), None

    def hess_blocks_aux(Z, lam, w, aux):
        if nlp.analytic is not None and aux is not None:
            H, C = _cost_hess(Z, w)
            if exact_hessian:
                Hc, Cc = nlp.analytic.defect_curvature(lam, aux)
                H, C = H + Hc, C + Cc
            return H, C
        return hess_blocks(Z, lam, w)

    if nlp.analytic is not None:
        defects = nlp.analytic.defects  # noqa: F811 (structured fast path)

    return NLPFunctions(
        total_cost=total_cost,
        defects=defects,
        ineqs=ineqs,
        grad_lagrangian=grad_lagrangian,
        hess_blocks=hess_blocks,
        jac_blocks=jac_blocks,
        grad_cost=grad_cost,
        dyn_eval=dyn_eval,
        hess_blocks_aux=hess_blocks_aux,
    )
