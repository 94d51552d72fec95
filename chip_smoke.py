"""Chip smoke test: the batched collocation solver on the GPU, end to end.

    python chip_smoke.py             # one card: phases 1-3
    python chip_smoke.py --cards 4   # four cards: the mesh phase only

Phases (one process; any failure exits non-zero before the final line):
  1. device check — every JAX device is a GPU; prints the card as
     `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
     it, the JAX/jaxlib versions and XLA_FLAGS.
  2. KKT kernel check — the Triton KKT kernels, `jax.vmap(solve_kkt)` (XLA)
     and the f64 C++ oracle on the same random well-conditioned blocks at
     the bench's stage widths; prints each backend's relative error, the
     tolerance, the precision and the times.
  3. main path — Hadamard, transmon leakage and CNOT through the public
     entry points (`solve_batched`, `solve_multistart`) at the bench's
     sizes and options; prints compile and solve seconds, the compiled
     solve loop's memory_analysis(), and the fraction of instances that
     pass host-f64 rollout validation at the bench's bar (>= 0.8 needed).
  4. (--cards 4 only) the SU(4) multigoal batch (1024 goals x 4 seeds)
     on a 4-card mesh through `parallel.batched_solve`, against the same
     batch on one card in the same process.

The last stdout line is {"ok": true, "device": {"platform", "kind",
"count"}}.  `--rehearse-cpu` runs every phase at toy sizes on the host CPU
(kernels in the Pallas interpreter) and never prints that line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# phase-2 widths (d, s, T, B): Hadamard, transmon leakage, CNOT
KKT_WIDTHS = ((15, 13, 51, 512), (28, 22, 40, 256), (47, 42, 40, 128))
MIN_FRAC = 0.8
# the bench's solver settings (bench.py:_solver_options defaults) with
# full-f32 products for evaluation as well as factorization
SOLVER_KW = dict(print_level=1, tol=1e-5, matmul_precision="highest",
                 eval_precision="highest", kappa_mu=0.2,
                 line_search="filter")


def _say(msg):
    print(msg, flush=True)


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------- #
def phase_device(n_cards, rehearse):
    import jax
    import jaxlib

    from quantumcollocation_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    from bench import nvidia_smi_card

    cache = enable_persistent_cache()
    if rehearse:
        jax.config.update("jax_platforms", "cpu")
    devs = jax.devices()
    if not rehearse:
        if any(d.platform != "gpu" for d in devs):
            _fail(f"JAX found no GPU (devices: {devs}); nothing was run")
        if len(devs) < n_cards:
            _fail(f"{n_cards} cards asked for, JAX sees {len(devs)}")
        card = nvidia_smi_card()
        if card is None:
            _fail("nvidia-smi reported no card")
        _say(card)
    _say(f"[1] devices: {len(devs)} x {devs[0].device_kind} "
         f"({devs[0].platform}); jax {jax.__version__}, jaxlib "
         f"{jaxlib.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
         f"compile cache {cache}")
    return devs


def phase_kernel(rehearse):
    from quantumcollocation_tpu.solver.kkt_check import check_kkt_backends

    widths = ((15, 13, 6, 3), (28, 22, 5, 2), (47, 42, 4, 2)) if rehearse \
        else KKT_WIDTHS
    for d, s, T, B in widths:
        r = check_kkt_backends(d, s, T, B, interpret=rehearse,
                               repeats=1 if rehearse else 10)
        _say(
            f"[2] KKT d={d} s={s} T={T} B={B}: rel err vs f64 oracle "
            f"triton {r['rel_err_triton']:.3e}, xla {r['rel_err_xla']:.3e} "
            f"(tol {r['rtol']:.0e}, {r['precision']}); time triton "
            f"{r['ms_triton']:.3f} ms, xla {r['ms_xla']:.3f} ms"
        )
        if not r["ok"]:
            _fail(f"KKT kernel check failed at d={d}: {r}")


def matmul_precision_report():
    """Relative error of a float32 product at each precision setting
    against float64: ~1e-3 means TF32 products, ~1e-7 full f32."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 256))
    y = rng.standard_normal((256, 256))
    ref = x @ y
    out = {}
    for prec in ("default", "high", "highest"):
        with jax.default_matmul_precision(prec):
            z = jax.jit(jnp.dot)(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(y, jnp.float32))
        out[prec] = float(np.abs(np.asarray(z, np.float64) - ref).max()
                          / np.abs(ref).max())
    return out


def _memory_line(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(m, f, 0) / 2**20:.1f} MiB"
        for f in fields
    )


def compile_solve_loop(solver, Z0, iters):
    """AOT-compile the solver's device loop for this batch shape; returns
    (compiled, seconds).  The persistent cache then serves the entry
    point's own compilation of the same program."""
    import jax
    import jax.numpy as jnp

    state = jax.eval_shape(solver._init_state_jit, jnp.asarray(Z0))
    t0 = time.perf_counter()
    compiled = type(solver)._solve_loop.lower(
        solver, state, iters, True
    ).compile()
    return compiled, time.perf_counter() - t0


def _run_problem(name, prob, solve, Z0_shape_src, iters, infidelities, bar):
    """Compile, warm, time one entry-point call, and validate on the host.
    solve(seed) -> IPMResult; infidelities(Z) -> (B,) host-f64 values."""
    import jax

    compiled, compile_s = compile_solve_loop(prob.solver, Z0_shape_src, iters)
    t0 = time.perf_counter()
    jax.block_until_ready(solve(1).Z)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve(2)
    jax.block_until_ready(res.Z)
    solve_s = time.perf_counter() - t0
    infid = infidelities(np.asarray(res.Z))
    frac = float(np.mean(infid <= bar))
    _say(
        f"[3] {name}: B={Z0_shape_src.shape[0]} T={Z0_shape_src.shape[1]} "
        f"d={Z0_shape_src.shape[2]} iters={iters} kkt_backend="
        f"{prob.solver.options.kkt_backend}; compile {compile_s:.1f} s, "
        f"first call {first_s:.2f} s, solve {solve_s:.3f} s "
        f"({1e3 * solve_s / iters:.2f} ms/iter); memory: "
        f"{_memory_line(compiled)}; host-f64 pass fraction at {bar:g}: "
        f"{frac:.4f} (median infidelity {float(np.median(infid)):.2e})"
    )
    if frac < MIN_FRAC:
        _fail(f"{name}: pass fraction {frac:.4f} < {MIN_FRAC}")


def phase_main_path(rehearse):
    import quantumcollocation_tpu as qct

    from bench import (
        build_cnot,
        build_hadamard,
        build_leakage,
        perturbed_seeds,
        validate,
    )

    rep = matmul_precision_report()
    _say("[3] float32 matmul rel err vs f64 by precision: " + ", ".join(
        f"{k} {v:.1e}" for k, v in rep.items()
    ) + f"; this phase runs matmul_precision={SOLVER_KW['matmul_precision']}"
        f", eval_precision={SOLVER_KW['eval_precision']}")
    opts = qct.SolverOptions(
        **SOLVER_KW, kkt_interpret=rehearse,
        **({"kkt_backend": "triton"} if rehearse else {}),
    )
    # (B, T, iters) per problem; toy sizes for the CPU rehearsal
    sizes = {"hadamard": (512, 51, 48), "leakage": (256, 40, 120),
             "cnot": (128, 40, 80)}
    if rehearse:
        sizes = {"hadamard": (4, 11, 6), "leakage": (2, 8, 4),
                 "cnot": (2, 8, 4)}

    def fids(prob, sys_q, goal, subspace=None):
        return lambda Z: 1.0 - validate(prob, sys_q, Z, goal, subspace)

    B, T, it = sizes["hadamard"]
    prob, sys_q, goal = build_hadamard(qct, opts, T=T)
    _run_problem(
        "hadamard", prob,
        lambda seed: prob.solve_batched(
            perturbed_seeds(prob, B, 0.1, seed), max_iter=it),
        perturbed_seeds(prob, B, 0.1, 0), it, fids(prob, sys_q, goal),
        1e-4 if not rehearse else 1.0,
    )

    B, T, it = sizes["leakage"]
    prob, sys_q, U_goal = build_leakage(qct, opts, T=T)
    _run_problem(
        "leakage", prob,
        lambda seed: prob.solve_batched(
            perturbed_seeds(prob, B, 0.05, seed), max_iter=it),
        perturbed_seeds(prob, B, 0.05, 0), it,
        fids(prob, sys_q, np.asarray(U_goal.operator),
             np.asarray(U_goal.subspace)),
        1e-3 if not rehearse else 1.0,
    )

    B, T, it = sizes["cnot"]
    prob, sys_q, goal = build_cnot(qct, opts, T=T)

    def multistart(seed):
        prob.solve_multistart(n_seeds=B, sigma=0.3, max_iter=it,
                              rng=np.random.default_rng(seed))
        return prob.result

    _run_problem(
        "cnot (solve_multistart)", prob, multistart,
        prob.multistart_initial_decisions(
            B, sigma=0.3, rng=np.random.default_rng(0)),
        it, fids(prob, sys_q, goal), 1e-4 if not rehearse else 1.0,
    )


# --------------------------------------------------------------------- #
def phase_mesh(n_cards, rehearse):
    """SU(4) multigoal on an n-card mesh vs the same batch on one card.

    Agreement: the converged fractions at infidelity 1e-4 may differ by at
    most 0.02, and at least 95% of instances must agree in host-f64
    fidelity to 1e-4.  Not bitwise: after 80 iterations of a non-convex
    solve, XLA may pick other algorithms for another shard size, and a
    last-bit difference can send a marginal instance to another basin."""
    import jax
    import jax.numpy as jnp

    import quantumcollocation_tpu as qct
    from quantumcollocation_tpu.parallel import batched_solve, make_mesh
    from quantumcollocation_tpu.problems import (
        UnitaryMultiGoalProblem,
        multigoal_initial_decisions,
        multigoal_rollout_fidelities,
        random_su,
    )

    from bench import _two_qubit_system

    n_goals, n_seeds, T, iters = (1024, 4, 33, 80) if not rehearse \
        else (4, 2, 8, 6)
    opts = qct.SolverOptions(**SOLVER_KW)
    prob = UnitaryMultiGoalProblem(
        _two_qubit_system(qct), T, 0.3, Q=1e4, R=1e-3,
        ipopt_options=opts,
        piccolo_options=qct.PiccoloOptions(verbose=False, free_time=False),
    )
    rng = np.random.default_rng(2024)
    goals = [random_su(4, rng) for _ in range(n_goals)]
    Z0 = np.asarray(multigoal_initial_decisions(
        prob, goals, n_seeds_per_goal=n_seeds, sigma=0.2,
        rng=np.random.default_rng(100),
    ))
    mesh = make_mesh(n_cards)
    one = jax.devices()[0]

    def timed(fn):
        jax.block_until_ready(fn().Z)  # compile + warm
        t0 = time.perf_counter()
        res = fn()
        jax.block_until_ready(res.Z)
        return res, time.perf_counter() - t0

    res_n, t_n = timed(
        lambda: batched_solve(prob, jnp.asarray(Z0), mesh=mesh,
                              max_iter=iters))
    res_1, t_1 = timed(
        lambda: prob.solver.solve(jax.device_put(jnp.asarray(Z0), one),
                                  max_iter=iters))
    f_n = np.asarray(multigoal_rollout_fidelities(
        prob, np.asarray(res_n.Z), goals, n_seeds_per_goal=n_seeds))
    f_1 = np.asarray(multigoal_rollout_fidelities(
        prob, np.asarray(res_1.Z), goals, n_seeds_per_goal=n_seeds))
    frac_n = float(np.mean(1.0 - f_n <= 1e-4))
    frac_1 = float(np.mean(1.0 - f_1 <= 1e-4))
    agree = float(np.mean(np.abs(f_n - f_1) <= 1e-4))
    eff = t_1 / (n_cards * t_n)
    _say(
        f"[4] su4 multigoal B={Z0.shape[0]} T={T} iters={iters}: "
        f"{n_cards}-card mesh {t_n:.3f} s, one card {t_1:.3f} s, 1 -> "
        f"{n_cards} efficiency {eff:.3f}; converged frac@1e-4 mesh "
        f"{frac_n:.4f} vs one card {frac_1:.4f}; instances agreeing to "
        f"1e-4 in host-f64 fidelity {agree:.4f}; max |dF| "
        f"{float(np.abs(f_n - f_1).max()):.2e}"
    )
    if abs(frac_n - frac_1) > 0.02 or agree < 0.95:
        _fail("mesh and one-card results disagree beyond the tolerance")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run the four-card mesh phase (and no other)")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="every phase at toy sizes on the host CPU; "
                    "prints no final result line")
    args = ap.parse_args()
    if args.rehearse_cpu and args.cards > 1:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cards}"
        )
    t0 = time.perf_counter()
    devs = phase_device(args.cards, args.rehearse_cpu)
    if args.cards > 1:
        phase_mesh(args.cards, args.rehearse_cpu)
    else:
        phase_kernel(args.rehearse_cpu)
        phase_main_path(args.rehearse_cpu)
    _say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.rehearse_cpu:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
