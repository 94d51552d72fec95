"""Benchmark: the five BASELINE.json canonical configs on one GPU.

Each config reports converged solves per second per card at its
host-validated f64 rollout bar:
  hadamard  batched single-qubit Hadamard smooth pulse (infidelity 1e-4)
  min_time  UnitaryMinimumTimeProblem (free Δt, fidelity floor 0.9999)
  cnot      two-qubit CNOT smooth pulse (infidelity 1e-4)
  leakage   transmon gate with L1 leakage suppression (subspace 1e-3)
  su4       randomized SU(4) goals × seeds in ONE compiled solve
            (goal-as-pinned-data, problems/multigoal.py)

Every config runs in its own child process, one at a time (one JAX process
per card); the parent never imports JAX.  Each config prints its own JSON
line when it completes, full records land in artifacts/bench_full.json,
and the LAST stdout line is the summary:
  {"metric": ..., "value": N, "unit": ..., "detail": {"device": {...}, ...}}
where detail.device names the platform, device_kind, device count, and the
card's nvidia-smi name and power limit.  A failed config makes the run
exit non-zero.  Without --cpu the run refuses to start unless JAX finds a
GPU; --cpu is an explicit rehearsal on the host.

Usage: python bench.py [--configs hadamard,min_time,cnot,leakage,su4|all]
                       [--batch B] [--iters N] [--smoke] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def nvidia_smi_card():
    """`name, power.limit` of the first card as nvidia-smi reports it, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_record():
    """The device a result was measured on (imports JAX)."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": nvidia_smi_card(),
    }


# --------------------------------------------------------------------- #
# problem builders (shared with chip_smoke.py)
# --------------------------------------------------------------------- #
def _two_qubit_system(qct):
    P = qct.PAULIS
    drives = [np.kron(P["Z"], P["X"]), np.kron(P["X"], P["I"]),
              np.kron(P["Y"], P["I"]), np.kron(P["I"], P["X"]),
              np.kron(P["I"], P["Y"])]
    return qct.QuantumSystem(0.1 * np.kron(P["Z"], P["Z"]), drives)


def build_hadamard(qct, options, T=51, dt=0.2):
    """(problem, system, goal) — Q/R chosen so the NLP optimum is well
    below the 1e-4 infidelity target (the README default Q=100, R=1e-2
    optimum sits at ~2.7e-4)."""
    sys_q = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])
    prob = qct.UnitarySmoothPulseProblem(
        sys_q, qct.GATES["H"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=options,
        piccolo_options=qct.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )
    return prob, sys_q, np.asarray(qct.GATES["H"])


def build_leakage(qct, options, T=40, dt=0.2):
    """(problem, system, embedded goal) — dt=0.2 (8 time units total): at
    dt=0.1 the problem's OPTIMUM sits at ~3e-3 subspace infidelity (pulse
    too short for the 0.5 drive bound), so no iteration count can pass the
    1e-3 bar."""
    from quantumcollocation_tpu.systems import TransmonSystem

    sys_q = TransmonSystem(omega=4.0, delta=0.2, levels=3)
    U_goal = qct.EmbeddedOperator(qct.GATES["X"], sys_q)
    prob = qct.UnitarySmoothPulseProblem(
        sys_q, U_goal, T, dt, a_bound=0.5, Q=1e4, R=1e-3,
        ipopt_options=options,
        piccolo_options=qct.PiccoloOptions(
            verbose=False, leakage_suppression=True, R_leakage=1e-1,
            free_time=False,
        ),
        rng=np.random.default_rng(11),
    )
    return prob, sys_q, U_goal


def build_cnot(qct, options, T=40, dt=0.3):
    sys_q = _two_qubit_system(qct)
    prob = qct.UnitarySmoothPulseProblem(
        sys_q, qct.GATES["CX"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=options,
        piccolo_options=qct.PiccoloOptions(verbose=False, free_time=False),
        rng=np.random.default_rng(7),
    )
    return prob, sys_q, np.asarray(qct.GATES["CX"])


def perturbed_seeds(prob, B, sigma, seed):
    """(B, T, d) copies of the problem's initial decision with Gaussian
    noise on the interior controls."""
    z0 = np.asarray(prob.initial_decision(1))[0]
    a_sl = prob.trajectory.comp_slice("a")
    T = z0.shape[0]
    rng = np.random.default_rng(seed)
    Z0 = np.broadcast_to(z0, (B, *z0.shape)).copy()
    Z0[:, 1:-1, a_sl] += sigma * rng.standard_normal(
        (B, T - 2, a_sl.stop - a_sl.start)
    )
    return Z0


# --------------------------------------------------------------------- #
def _timed(solver, seeds_fn, iters, repeats, dtype):
    """Compile + time repeated batched solves on fresh seeds per repeat.
    The first call compiles (reported as set-up); a discarded warm run
    precedes the timed repeats."""
    import jax
    import jax.numpy as jnp

    solve = jax.jit(
        lambda z: solver._solve_loop(solver.init_state(z), iters)
    )
    t_c0 = time.perf_counter()
    jax.block_until_ready(solve(jnp.asarray(seeds_fn(7), dtype)))
    compile_s = time.perf_counter() - t_c0
    jax.block_until_ready(solve(jnp.asarray(seeds_fn(6), dtype)))
    times = []
    for rep in range(repeats):
        Z0j = jax.block_until_ready(jnp.asarray(seeds_fn(42 + rep), dtype))
        t0 = time.perf_counter()
        state = jax.block_until_ready(solve(Z0j))
        times.append(time.perf_counter() - t0)
    return state, min(times), compile_s


def validate(prob, sys_q, Z, goal, subspace=None):
    """(B,) host-f64 rollout fidelities of solutions Z (problem units)."""
    from quantumcollocation_tpu.utils.host_validation import (
        extract_controls,
        host_gate_fidelities,
    )

    a_all, dts_all = extract_controls(prob, Z)
    return host_gate_fidelities(sys_q, a_all, dts_all, goal, subspace)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _solver_options(qct, args, **over):
    kw = dict(
        print_level=1,
        tol=1e-5,
        matmul_precision=args.precision,
        eval_precision=args.eval_precision,
        kkt_backend=args.kkt_backend,
        kappa_mu=args.kappa_mu,
        line_search=args.line_search,
        mu_strategy=args.mu_strategy,
    )
    kw.update(over)
    return qct.SolverOptions(**kw)


def bench_hadamard(qct, args, dtype):
    B = args.batch
    prob, sys_q, goal = build_hadamard(qct, _solver_options(qct, args))
    state, wall, compile_s = _timed(
        prob.solver, lambda s: perturbed_seeds(prob, B, 0.1, s),
        args.iters, args.repeats, dtype,
    )
    infid = 1.0 - validate(
        prob, sys_q, prob.solver.unscale(np.asarray(state.Z)), goal
    )
    frac_ok = float(np.mean(infid <= 1e-4))
    return {
        "metric": "hadamard_solves_per_s_per_card_at_infid_1e-4",
        "value": B * frac_ok / wall,
        "unit": "solves/s/card",
        "batch": B,
        "ipm_iters": args.iters,
        "wall_s": wall,
        "compile_s": compile_s,
        "converged_frac": frac_ok,
        "best_infid": float(infid.min()),
        "median_infid": float(np.median(infid)),
        "kkt_iters_per_s": args.iters * B / wall,
    }


def bench_min_time(qct, args, dtype):
    B, T, dt = args.batch, 51, 0.2
    sys_q = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])
    # stage 1: high-quality fixed-time warm start (one B=1 solve, set-up)
    warm = qct.UnitarySmoothPulseProblem(
        sys_q, qct.GATES["H"], T, dt, Q=1e4, R=1e-3,
        ipopt_options=_solver_options(qct, args, tol=1e-7, recalc_y="yes",
                                      recalc_y_feas_tol=1e1),
        piccolo_options=qct.PiccoloOptions(verbose=False, free_time=False),
        rng=np.random.default_rng(0),
    )
    warm.solve(max_iter=80)
    fid_warm = float(qct.unitary_rollout_fidelity(warm.trajectory, sys_q))

    # stage 2: free-time minimum-time problem warm-started from stage 1
    traj2 = qct.initialize_unitary_trajectory(
        qct.GATES["H"], T, dt, 2,
        [np.ones(2), np.full(2, np.inf), np.ones(2)],
        free_time=True, a_guess=np.asarray(warm.trajectory["a"]),
        system=sys_q,
    )
    dur0 = float(traj2.duration())
    # D=1000 so the time objective overcomes the carried Q=1e4 infidelity
    # term (D=10 -> durations GROW; D=100 -> -0.1%; D=1000 -> -2%/-3%).
    # The floor sits ABOVE the 0.9999 success bar: the solver drives
    # fidelity exactly onto the floor, so a floor AT the bar leaves half
    # the seeds a hair below it in f64 host validation; 5e-5 of margin
    # clears the f32 noise band.
    mt = qct.UnitaryMinimumTimeProblem(
        traj2, sys_q, warm.get_objective(), warm.integrators, [],
        final_fidelity=0.99995, D=1000.0,
        ipopt_options=_solver_options(qct, args, tol=1e-6),
    )
    # tiny perturbations keep every seed inside the fidelity-floor basin
    state, wall, compile_s = _timed(
        mt.solver, lambda s: perturbed_seeds(mt, B, 1e-4, s),
        args.iters, args.repeats, dtype,
    )
    from quantumcollocation_tpu.utils.host_validation import extract_controls

    Z = mt.solver.unscale(np.asarray(state.Z))
    fids = validate(mt, sys_q, Z, np.asarray(qct.GATES["H"]))
    durs = extract_controls(mt, Z)[1][:, :-1].sum(axis=1)
    ok = (fids >= 0.9999) & (durs < dur0)
    return {
        "metric": "min_time_solves_per_s_per_card_at_fid_0.9999",
        "value": B * float(ok.mean()) / wall,
        "unit": "solves/s/card",
        "batch": B,
        "ipm_iters": args.iters,
        "wall_s": wall,
        "compile_s": compile_s,
        "success_frac": float(ok.mean()),
        "warm_fid": fid_warm,
        "duration_before": dur0,
        "median_duration_after": float(np.median(durs)),
        "median_fid": float(np.median(fids)),
    }


def bench_cnot(qct, args, dtype):
    B = max(args.batch // 4, 8)
    prob, sys_q, goal = build_cnot(qct, _solver_options(qct, args))

    def seeds(seed):
        return np.asarray(prob.multistart_initial_decisions(
            B, sigma=0.3, rng=np.random.default_rng(seed)
        ))

    iters = args.iters_2q
    state, wall, compile_s = _timed(
        prob.solver, seeds, iters, args.repeats, dtype
    )
    infid = 1.0 - validate(
        prob, sys_q, prob.solver.unscale(np.asarray(state.Z)), goal
    )
    frac4 = float(np.mean(infid <= 1e-4))
    return {
        "metric": "cnot_solves_per_s_per_card_at_infid_1e-4",
        "value": B * frac4 / wall,
        "unit": "solves/s/card",
        "batch": B,
        "ipm_iters": iters,
        "wall_s": wall,
        "compile_s": compile_s,
        "frac_infid_1e-4": frac4,
        "frac_infid_1e-3": float(np.mean(infid <= 1e-3)),
        "frac_infid_1e-2": float(np.mean(infid <= 1e-2)),
        "best_infid": float(infid.min()),
        "median_infid": float(np.median(infid)),
    }


def bench_transmon_leakage(qct, args, dtype):
    B = max(args.batch // 2, 8)
    prob, sys_q, U_goal = build_leakage(qct, _solver_options(qct, args))
    # 120 iters: with the kkt_aug lift the >1e-4 tail is pure slow
    # convergence — measured 0.875 @ 80 iters -> 1.000 @ 120 (CPU-f32 B=64)
    iters = args.iters_leakage
    state, wall, compile_s = _timed(
        prob.solver, lambda s: perturbed_seeds(prob, B, 0.05, s),
        iters, args.repeats, dtype,
    )
    infid = 1.0 - validate(
        prob, sys_q, prob.solver.unscale(np.asarray(state.Z)),
        np.asarray(U_goal.operator), np.asarray(U_goal.subspace),
    )
    frac3 = float(np.mean(infid <= 1e-3))
    return {
        "metric": "transmon_leakage_solves_per_s_per_card_at_subspace_infid_1e-3",
        "value": B * frac3 / wall,
        "unit": "solves/s/card",
        "batch": B,
        "ipm_iters": iters,
        "wall_s": wall,
        "compile_s": compile_s,
        "frac_subspace_infid_1e-3": frac3,
        "frac_subspace_infid_1e-2": float(np.mean(infid <= 1e-2)),
        "frac_subspace_infid_1e-4": float(np.mean(infid <= 1e-4)),
        "best_infid": float(infid.min()),
        "median_infid": float(np.median(infid)),
    }


def bench_su4_multigoal(qct, args, dtype):
    import jax
    import jax.numpy as jnp

    from quantumcollocation_tpu.problems import (
        UnitaryMultiGoalProblem,
        multigoal_initial_decisions,
        multigoal_rollout_fidelities,
        random_su,
    )

    n_goals, n_seeds = args.su4_goals, args.su4_seeds
    prob = UnitaryMultiGoalProblem(
        _two_qubit_system(qct), 33, 0.3, Q=1e4, R=1e-3,
        ipopt_options=_solver_options(qct, args),
        piccolo_options=qct.PiccoloOptions(verbose=False, free_time=False),
    )
    solver = prob.solver
    iters = args.iters_2q
    rng = np.random.default_rng(2024)
    goals = [random_su(4, rng) for _ in range(n_goals)]
    solve = jax.jit(lambda z: solver._solve_loop(solver.init_state(z), iters))

    def seeds(seed):
        return jnp.asarray(np.asarray(multigoal_initial_decisions(
            prob, goals, n_seeds_per_goal=n_seeds, sigma=0.2,
            rng=np.random.default_rng(seed),
        )), dtype)

    t0 = time.perf_counter()
    jax.block_until_ready(solve(seeds(100)))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(solve(seeds(300)))  # discarded warm run
    Z0j = jax.block_until_ready(seeds(200))
    t0 = time.perf_counter()
    state = jax.block_until_ready(solve(Z0j))
    wall = time.perf_counter() - t0
    fids = np.asarray(multigoal_rollout_fidelities(
        prob, solver.unscale(np.asarray(state.Z)), goals,
        n_seeds_per_goal=n_seeds,
    ))
    infid = 1.0 - fids
    B_total = n_goals * n_seeds
    per_goal_best = fids.reshape(n_goals, n_seeds).max(axis=1)
    frac4 = float(np.mean(infid <= 1e-4))
    return {
        "metric": "su4_multigoal_solves_per_s_per_card_at_infid_1e-4",
        "value": B_total * frac4 / wall,
        "unit": "solves/s/card",
        "batch_total": B_total,
        "goals": n_goals,
        "seeds_per_goal": n_seeds,
        "ipm_iters": iters,
        "wall_s": wall,
        "compile_s": compile_s,
        "frac_infid_1e-4": frac4,
        "frac_infid_1e-3": float(np.mean(infid <= 1e-3)),
        "goal_frac_solved_1e-4": float(np.mean(1.0 - per_goal_best <= 1e-4)),
        "goal_frac_solved_1e-3": float(np.mean(1.0 - per_goal_best <= 1e-3)),
        "median_infid": float(np.median(infid)),
    }


BENCHES = {
    "hadamard": bench_hadamard,
    "min_time": bench_min_time,
    "cnot": bench_cnot,
    "leakage": bench_transmon_leakage,
    "su4": bench_su4_multigoal,
}


# --------------------------------------------------------------------- #
def _child_cmd(name, args):
    cmd = [
        sys.executable, os.path.abspath(__file__), "--child",
        "--configs", name,
        "--batch", str(args.batch), "--iters", str(args.iters),
        "--iters-2q", str(args.iters_2q), "--repeats", str(args.repeats),
        "--iters-leakage", str(args.iters_leakage),
        "--precision", args.precision,
        "--eval-precision", args.eval_precision,
        "--kkt-backend", args.kkt_backend,
        "--kappa-mu", str(args.kappa_mu),
        "--line-search", args.line_search, "--mu-strategy", args.mu_strategy,
        "--su4-goals", str(args.su4_goals), "--su4-seeds", str(args.su4_seeds),
    ]
    return cmd + (["--cpu"] if args.cpu else [])


def _run_config_subprocess(name, args, timeout_s):
    """One config in its own process (its own JAX client): a runtime
    error in one config cannot poison the others'."""
    try:
        out = subprocess.run(
            _child_cmd(name, args), capture_output=True, text=True,
            timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return {"metric": name, "error": f"timeout after {timeout_s}s"}
    if out.returncode == 0:
        for line in reversed(out.stdout.strip().splitlines()):
            try:
                return json.loads(line)
            except (json.JSONDecodeError, ValueError):
                continue
    tail = (out.stderr or "").strip().splitlines()[-3:]
    return {
        "metric": name,
        "error": f"child rc={out.returncode}: {' | '.join(tail)[-400:]}",
    }


def _run_child(name, args):
    """In-process config run: the device check, then one JSON record."""
    import jax

    from quantumcollocation_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_persistent_cache()
    if not args.cpu and jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench: no GPU found (JAX backend {jax.default_backend()!r}); "
            "pass --cpu for a host rehearsal"
        )
    import jax.numpy as jnp

    import quantumcollocation_tpu as qct

    dtype = jnp.float64 if (args.cpu and jax.config.jax_enable_x64) else (
        jnp.float32
    )
    rec = BENCHES[name](qct, args, dtype)
    rec["device"] = device_record()
    _emit(rec)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=512)
    # 48 balances the headline against converged_frac (44 iters -> frac
    # 0.908; 48 -> 0.961; 52 -> 0.982 at B=512)
    parser.add_argument("--iters", type=int, default=48)
    parser.add_argument("--iters-2q", dest="iters_2q", type=int, default=80)
    parser.add_argument(
        "--iters-leakage", dest="iters_leakage", type=int, default=120,
        help="leakage-config IPM iterations (slow-converger tail reaches "
        "the bar by ~120; docs in bench_transmon_leakage)",
    )
    # 0.2 (Ipopt's default): frac@1e-4 0.889 at 0.1 vs 0.982 at 0.2 at 48
    # iters (filter line search)
    parser.add_argument("--kappa-mu", dest="kappa_mu", type=float, default=0.2)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument(
        "--cpu", action="store_true",
        help="run on the host CPU (an explicit rehearsal, never a fallback)",
    )
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--precision", type=str, default="highest")
    parser.add_argument(
        "--eval-precision", dest="eval_precision", type=str, default="high",
    )
    parser.add_argument(
        "--kkt-backend", dest="kkt_backend", type=str, default="auto",
        help="SolverOptions.kkt_backend (default auto: the solver's policy)",
    )
    parser.add_argument(
        "--line-search", dest="line_search", type=str, default="filter"
    )
    parser.add_argument(
        "--mu-strategy", dest="mu_strategy", type=str, default="monotone"
    )
    parser.add_argument(
        "--configs", type=str, default="all",
        help="comma list of hadamard,min_time,cnot,leakage,su4 (or all)",
    )
    # 1024 goals x 4 seeds = 4096 instances (the BASELINE-named su4 batch)
    parser.add_argument("--su4-goals", dest="su4_goals", type=int, default=1024)
    parser.add_argument("--su4-seeds", dest="su4_seeds", type=int, default=4)
    parser.add_argument(
        "--child", action="store_true",
        help="internal: run the one requested config in-process",
    )
    parser.add_argument(
        "--config-timeout", dest="config_timeout", type=int, default=1500,
        help="per-config subprocess timeout (seconds)",
    )
    args = parser.parse_args()
    if args.smoke:
        args.batch, args.iters, args.repeats = 8, 30, 1
        args.iters_2q = 30
        args.iters_leakage = 30
        args.su4_goals, args.su4_seeds = 2, 2
        if args.configs == "all":
            args.configs = "hadamard"

    names = (
        list(BENCHES) if args.configs == "all"
        else [c.strip() for c in args.configs.split(",")]
    )
    if args.child:
        _run_child(names[0], args)
        return 0

    results = {}
    for name in names:
        print(f"[bench] running config {name}...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        r = _run_config_subprocess(name, args, args.config_timeout)
        r["config_total_s"] = time.perf_counter() - t0
        results[name] = r
        _emit(r)

    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/bench_full.json", "w") as f:
        json.dump({"configs": results}, f, indent=1)
    failed = [n for n, r in results.items() if "error" in r]
    ok = [r for r in results.values() if "error" not in r]
    head = results.get("hadamard")
    if head is None or "error" in head:
        head = ok[0] if ok else {"metric": "bench_failed", "value": 0.0}
    _emit({
        "metric": head["metric"],
        "value": head.get("value", 0.0),
        "unit": "solves/s/card",
        "detail": {
            "device": next((r["device"] for r in ok), None),
            "kkt_backend": args.kkt_backend,
            "failed": failed,
            "configs": {
                n: r.get("value", "error") for n, r in results.items()
            },
            **{k: head[k] for k in ("converged_frac", "wall_s", "batch")
               if k in head},
        },
    })
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
