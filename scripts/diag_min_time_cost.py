"""Diagnostic: where does the min_time per-iteration cost go?

The min_time iteration was measured far slower than the hadamard one at
the same batch — a gap the kkt_aug lift cannot explain by FLOPs alone (12
retry factorizations would be ~3x).  This script quantifies, on CPU
(structure) at the bench shapes scaled down:

1. retry pressure: per-iteration reg_dw (delta_w used in the accepted
   factorization) over the solve — from which the while_loop trip count
   follows (k=0: dw=0; k=1: dw0/3 or 1e-4; k>=2: x8 per retry);
2. per-iteration wall of the min_time step vs the hadamard step under
   identical backend/batch, for kkt_aug on/off.

Usage: python scripts/diag_min_time_cost.py [--batch 64] [--iters 44]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import quantumcollocation_tpu as qct

p = argparse.ArgumentParser()
p.add_argument("--batch", type=int, default=64)
p.add_argument("--iters", type=int, default=44)
p.add_argument("--f64", action="store_true")
p.add_argument("--rho-factor", dest="rho_factor", type=float, default=None)
p.add_argument("--skip-timing", action="store_true")
args = p.parse_args()
if args.f64:
    jax.config.update("jax_enable_x64", True)
B, T, dt = args.batch, 51, 0.2
dtype = jnp.float64 if args.f64 else jnp.float32

sys_q = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])


def build_mt(**over):
    warm = qct.UnitarySmoothPulseProblem(
        sys_q, qct.GATES["H"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=qct.SolverOptions(
            print_level=1, tol=1e-7, recalc_y="yes", recalc_y_feas_tol=1e1,
            kkt_backend="xla",
        ),
        piccolo_options=qct.PiccoloOptions(verbose=False, free_time=False),
        rng=np.random.default_rng(0),
    )
    warm.solve(max_iter=80)
    a_solved = np.asarray(warm.trajectory["a"])
    traj2 = qct.initialize_unitary_trajectory(
        qct.GATES["H"], T, dt, 2,
        [np.ones(2), np.full(2, np.inf), np.ones(2)],
        free_time=True, a_guess=a_solved, system=sys_q,
    )
    kw = dict(print_level=1, tol=1e-6, kkt_backend="xla")
    if args.rho_factor is not None:
        kw["kkt_aug_rho_factor"] = args.rho_factor
    kw.update(over)
    mt = qct.UnitaryMinimumTimeProblem(
        traj2, sys_q, warm.get_objective(), warm.integrators, [],
        final_fidelity=0.99995, D=1000.0,
        ipopt_options=qct.SolverOptions(**kw),
    )
    return mt


def seeds(prob, seed):
    z0 = np.asarray(prob.initial_decision(1))[0]
    a_sl = prob.trajectory.comp_slice("a")
    rng = np.random.default_rng(seed)
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    Z0[:, 1:-1, a_sl] += 1e-4 * rng.standard_normal(
        (B, T - 2, a_sl.stop - a_sl.start)
    )
    return Z0


print("== building min_time (kkt_aug auto) ==", flush=True)
mt = build_mt()
print("NLP dims: T=%d d=%d s=%d m=%d" % (
    mt.solver.nlp.T, mt.solver.nlp.d, mt.solver.nlp.s, mt.solver.nlp.m
))
print("kkt_aug_on:", mt.solver.kkt_aug_on)

Z0 = jnp.asarray(seeds(mt, 42), dtype)
st = mt.solver._init_state_jit(Z0)
dw_hist, alpha_hist, ls_hist = [], [], []
t0 = time.perf_counter()
for it in range(args.iters):
    st = mt.solver._solve_loop(st, 1)
    dw_hist.append(np.asarray(st.reg_dw))
    alpha_hist.append(np.asarray(st.alpha))
    ls_hist.append(np.asarray(st.ls_k))
jax.block_until_ready(st)
wall = time.perf_counter() - t0
dw = np.stack(dw_hist)  # (iters, B)
print(f"seg-1 walk wall {wall:.1f}s (includes per-seg dispatch overhead)")
print("per-iter frac instances with dw>0:",
      np.round((dw > 0).mean(axis=1), 3).tolist())
print("per-iter max dw:", np.round(dw.max(axis=1), 4).tolist())
print("per-iter mean ls_k:",
      np.round(np.stack(ls_hist).mean(axis=1), 2).tolist())

# implied retry count per iteration: attempts = 2 + log8(dw_max / dw1)
# when dw>0 (dw1 = first-retry dw), 1 when all dw==0
dw1 = np.where(dw > 0, dw, np.inf).min(axis=1)
with np.errstate(divide="ignore", invalid="ignore"):
    extra = np.where(
        dw.max(axis=1) > 0,
        2 + np.maximum(0, np.log(dw.max(axis=1) / np.maximum(dw1, 1e-12))
                       / np.log(8.0)),
        1.0,
    )
print("implied attempts/iter (upper bound):",
      np.round(extra, 1).tolist())

# ---- timing: fused 5-iter loops, min_time vs variants ------------------
def time_loop(prob, label, n=5, reps=3):
    solver = prob.solver
    Z0j = jnp.asarray(seeds(prob, 7), dtype)
    loop = jax.jit(lambda z: solver._solve_loop(solver.init_state(z), n))
    stx = loop(Z0j)
    jax.block_until_ready(stx)
    best = np.inf
    for r in range(reps):
        Zr = jnp.asarray(seeds(prob, 100 + r), dtype)
        jax.block_until_ready(Zr)
        t0 = time.perf_counter()
        stx = loop(Zr)
        jax.block_until_ready(stx)
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {1e3 * best / n:.1f} ms/iter (B={B})", flush=True)
    return best / n


if args.skip_timing:
    sys.exit(0)
print("\n== per-iteration timing (xla backend, CPU) ==")
time_loop(mt, "min_time aug=auto")
mt_off = build_mt(kkt_aug=False)
time_loop(mt_off, "min_time aug=off ")

had = qct.UnitarySmoothPulseProblem(
    sys_q, qct.GATES["H"], T, dt, Q=1e4, R=1e-3,
    ipopt_options=qct.SolverOptions(print_level=1, tol=1e-5,
                                    kkt_backend="xla"),
    piccolo_options=qct.PiccoloOptions(verbose=False),
    rng=np.random.default_rng(0),
)
time_loop(had, "hadamard (ref)   ")
