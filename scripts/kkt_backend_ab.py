"""KKT backend A/B on the card: ms per IPM iteration with each backend,
the iteration's phase split, and the matmul-precision quality check.

    python scripts/kkt_backend_ab.py [--iters 20] [--trace] [--out DIR]

For Hadamard (B=512, T=51), transmon leakage (B=256, T=40) and CNOT
(B=128, T=40) at the bench's options:
  - ms/iter of a fixed-trip device loop (`_solve_loop`, no early exit)
    for kkt_backend xla and triton, run in the order xla, triton, triton,
    xla (min per backend);
  - the phase split at the initial iterate: ms of the jitted assembly
    (residuals, Jacobian and Hessian blocks) and of the jitted KKT solve
    with its inertia retries, for each backend;
  - with --trace: a jax.profiler trace of 3 iterations on the xla backend,
    reduced to device time per phase by the solver's named scopes
    (qct_assembly, qct_kkt, qct_post) through the compiled HLO's op_name
    metadata.
Also: Hadamard at 48 iterations with eval_precision "high" vs "highest"
(host-f64 pass fraction at 1e-4 and wall).  Needs a GPU; writes a JSON
record to DIR/kkt_backend_ab.json (default kkt_ab_out/).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBLEMS = {"hadamard": (512, 0.1), "leakage": (256, 0.05), "cnot": (128, 0.3)}
SCOPES = ("qct_assembly", "qct_kkt", "qct_post")


def _build(qct, name, backend, **over):
    import bench

    kw = dict(print_level=0, tol=1e-5, matmul_precision="highest",
              eval_precision="highest", kappa_mu=0.2, line_search="filter",
              kkt_backend=backend)
    kw.update(over)
    builder = {"hadamard": bench.build_hadamard,
               "leakage": bench.build_leakage, "cnot": bench.build_cnot}[name]
    return builder(qct, qct.SolverOptions(**kw))


def _seeds(prob, name, seed):
    import bench

    B, sigma = PROBLEMS[name]
    if name == "cnot":
        return prob.multistart_initial_decisions(
            B, sigma=sigma, rng=np.random.default_rng(seed))
    return bench.perturbed_seeds(prob, B, sigma, seed)


def _ms_per_iter(solver, Z0, iters, repeats=2):
    import jax
    import jax.numpy as jnp

    def run():
        st = jax.block_until_ready(solver._init_state_jit(jnp.asarray(Z0)))
        t0 = time.perf_counter()
        jax.block_until_ready(solver._solve_loop(st, iters, False))
        return time.perf_counter() - t0

    run()  # compile + warm
    return 1e3 * min(run() for _ in range(repeats)) / iters


def _phase_split(solver, Z0, repeats=5):
    """(ms assembly, ms KKT) at the initial iterate, each jitted alone."""
    import jax
    import jax.numpy as jnp

    prec = solver.options.matmul_precision
    st = solver._init_state_jit(jnp.asarray(Z0))

    @jax.jit
    def pre(s):
        with jax.default_matmul_precision(prec):
            return jax.vmap(solver._iteration_pre)(s)

    @jax.jit
    def kkt(kin, dw):
        with jax.default_matmul_precision(prec):
            return solver._solve_kkt_batched(kin, dw)[:3]

    def best(fn, *a):
        jax.block_until_ready(fn(*a))
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            ts.append(time.perf_counter() - t0)
        return 1e3 * min(ts)

    kin, _ = pre(st)
    return best(pre, st), best(kkt, kin, st.delta_w)


def _scope_of_hlo(hlo_text):
    """HLO instruction name -> phase scope, from op_name metadata."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            for tag in SCOPES:
                if tag in m.group(2):
                    out[m.group(1)] = tag
                    break
    return out


def _trace_split(solver, Z0, iters, trace_dir):
    """Device time per phase over `iters` iterations (xla backend)."""
    import jax
    import jax.numpy as jnp

    st = solver._init_state_jit(jnp.asarray(Z0))
    compiled = type(solver)._solve_loop.lower(solver, st, iters, False).compile()
    scope = _scope_of_hlo(compiled.as_text())
    jax.block_until_ready(solver._solve_loop(st, iters, False))
    st = jax.block_until_ready(solver._init_state_jit(jnp.asarray(Z0)))
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(solver._solve_loop(st, iters, False))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    lines = {}
    for plane in pd.planes:
        if "GPU" not in plane.name and "gpu" not in plane.name:
            continue
        for line in plane.lines:
            acc = dict.fromkeys(SCOPES + ("other",), 0.0)
            t_lo, t_hi, n = None, None, 0
            for ev in line.events:
                # kernel names end in _N where the HLO name has .N
                names = [ev.name, re.sub(r"_(\d+)$", r".\1", ev.name)] + [
                    str(v) for _, v in ev.stats
                ]
                tag = next((scope[x] for x in names if x in scope), None)
                if tag is None:
                    tag = next((t for t in SCOPES
                                if any(t in x for x in names)), "other")
                acc[tag] += ev.duration_ns
                t_lo = ev.start_ns if t_lo is None else min(t_lo, ev.start_ns)
                t_hi = max(t_hi or 0, ev.start_ns + ev.duration_ns)
                n += 1
            if n:
                acc["events"] = n
                acc["window_ns"] = (t_hi - t_lo) if t_lo is not None else 0
                acc["sample"] = [e.name for e in list(line.events)[:5]]
                lines[f"{plane.name}/{line.name}"] = acc
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default="kkt_ab_out")
    args = ap.parse_args()

    import jax

    from quantumcollocation_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit("kkt_backend_ab: needs a GPU")
    import quantumcollocation_tpu as qct

    from bench import device_record, validate

    os.makedirs(args.out, exist_ok=True)
    rec = {"device": device_record(), "iters": args.iters, "problems": {}}
    print(json.dumps(rec["device"]), flush=True)

    # the kernel alone at each width, for each warp count per program
    from quantumcollocation_tpu.solver import kkt_triton
    from quantumcollocation_tpu.solver.kkt_check import check_kkt_backends

    default_warps = kkt_triton._num_warps
    rec["kernel_warps"] = {}
    for d, s, T, B in ((15, 13, 51, 512), (28, 22, 40, 256), (47, 42, 40, 128)):
        for nw in (1, 2, 4, 8):
            kkt_triton._num_warps = lambda Dp, _nw=nw: _nw
            r = check_kkt_backends(d, s, T, B, repeats=5, n_oracle=8)
            rec["kernel_warps"][f"d{d}_w{nw}"] = r
            print(f"kernel d={d} num_warps={nw}: triton {r['ms_triton']:.3f} "
                  f"ms, xla {r['ms_xla']:.3f} ms, err {r['rel_err_triton']:.2e}",
                  flush=True)
    kkt_triton._num_warps = default_warps
    for name in PROBLEMS:
        r = rec["problems"][name] = {}
        probs = {b: _build(qct, name, b)[0] for b in ("xla", "triton")}
        Z0 = _seeds(probs["xla"], name, 0)
        times = {"xla": [], "triton": []}
        for b in ("xla", "triton", "triton", "xla"):
            times[b].append(_ms_per_iter(probs[b].solver, Z0, args.iters))
        for b in ("xla", "triton"):
            r[f"ms_per_iter_{b}"] = min(times[b])
            r[f"ms_per_iter_{b}_runs"] = times[b]
            r[f"ms_assembly_{b}"], r[f"ms_kkt_{b}"] = _phase_split(
                probs[b].solver, Z0)
        if args.trace and name in ("hadamard", "cnot"):
            r["trace_xla"] = _trace_split(
                probs["xla"].solver, Z0, 3,
                os.path.join(args.out, f"trace_{name}"))
        print(name, json.dumps({k: v for k, v in r.items()
                                if not k.startswith("trace")}), flush=True)

    # precision quality check at the bench's Hadamard size
    for ev in ("high", "highest"):
        prob, sys_q, goal = _build(qct, "hadamard", "auto", eval_precision=ev)
        prob.solve_batched(_seeds(prob, "hadamard", 1), max_iter=48)
        t0 = time.perf_counter()
        res = prob.solve_batched(_seeds(prob, "hadamard", 2), max_iter=48)
        jax.block_until_ready(res.Z)
        wall = time.perf_counter() - t0
        infid = 1.0 - validate(prob, sys_q, np.asarray(res.Z), goal)
        rec[f"hadamard_eval_{ev}"] = {
            "wall_s": wall, "frac_1e-4": float(np.mean(infid <= 1e-4)),
            "median_infid": float(np.median(infid)),
        }
        print(f"hadamard eval_precision={ev}",
              json.dumps(rec[f"hadamard_eval_{ev}"]), flush=True)
    with open(os.path.join(args.out, "kkt_backend_ab.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
