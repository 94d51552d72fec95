"""Accuracy and timing check of the KKT backends against the f64 oracle.

Shared by the tests (interpret mode on the CPU, GPU-marked cases on the
card) and by `chip_smoke.py`: random well-conditioned stage blocks shaped
like the IPM's (SPD Hessian blocks with a weak coupling, a defect Jacobian
whose next-state block is near -I) are solved by the Triton kernels, by
`jax.vmap(solve_kkt)` (XLA), and by the float64 C++ oracle
`ops.native.kkt_solve_native`.  The error of a backend is the largest,
over instances, of max(|dz - dz*|_inf / |dz*|_inf, |nu - nu*|_inf /
|nu*|_inf).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["KKT_CHECK_RTOL", "random_kkt_blocks", "check_kkt_backends"]

# float32 arithmetic (eps 1.2e-7) through T stage eliminations of blocks
# with condition numbers ~10-100: the relative error lands near 1e-6..1e-5;
# 1e-4 leaves an order of magnitude of margin and still catches a wrong
# elimination (errors O(1)) or TF32 products (~1e-3)
KKT_CHECK_RTOL = 1e-4
DELTA_C = 1e-8


def random_kkt_blocks(B, T, d, s, seed=0):
    """float64 (H, C, A, B, rz, rnu), batch-first, well conditioned."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, T, d, d))
    H = np.einsum("btij,btkj->btik", M, M) / d + np.eye(d)
    C = 0.1 * rng.standard_normal((B, T - 1, d, d)) / np.sqrt(d)
    # defect Jacobians: -(propagator) on the state columns of z_t, the
    # identity on those of z_{t+1}, small control columns
    A = -np.eye(s, d) + 0.1 * rng.standard_normal((B, T - 1, s, d))
    Bm = np.eye(s, d) + 0.1 * rng.standard_normal((B, T - 1, s, d))
    rz = rng.standard_normal((B, T, d))
    rnu = rng.standard_normal((B, T - 1, s))
    return H, C, A, Bm, rz, rnu


def _rel_err(x, ref):
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    num = np.abs(x - ref).max(axis=1)
    den = np.maximum(np.abs(ref).max(axis=1), 1e-300)
    return float((num / den).max())


def _timed(fn, args, repeats):
    import jax

    out = jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, min(times)


def check_kkt_backends(d, s, T, B, *, interpret=False, seed=0, repeats=5,
                       n_oracle=None, dtype="float32"):
    """Solve one random batch with both backends and the oracle.

    Returns a dict: rel_err_triton, rel_err_xla, rtol, precision,
    ms_triton, ms_xla (min over `repeats` timed calls after a warm-up),
    and `ok` (both errors within rtol and every instance solved).
    n_oracle limits the oracle comparison to the first instances."""
    import jax
    import jax.numpy as jnp

    from ..ops.native import kkt_solve_native
    from .kkt import solve_kkt
    from .kkt_triton import solve_kkt_triton

    blocks64 = random_kkt_blocks(B, T, d, s, seed)
    args = [jnp.asarray(x, dtype) for x in blocks64]
    prec = "highest"

    @jax.jit
    def run_triton(*a):
        return solve_kkt_triton(*a, DELTA_C, interpret=interpret)

    @jax.jit
    def run_xla(*a):
        with jax.default_matmul_precision(prec):
            return jax.vmap(
                lambda h, c, a_, b, r1, r2: solve_kkt(
                    h, c, a_, b, r1, r2, DELTA_C
                )
            )(*a)

    (dz_t, nu_t, ok_t), ms_t = _timed(run_triton, args, repeats)
    (dz_x, nu_x, ok_x), ms_x = _timed(run_xla, args, repeats)

    n = B if n_oracle is None else min(n_oracle, B)
    dz_o = np.zeros((n, T, d))
    nu_o = np.zeros((n, T - 1, s))
    for b in range(n):
        dz_o[b], nu_o[b], _ = kkt_solve_native(
            *(x[b] for x in blocks64), DELTA_C
        )
    err_t = max(_rel_err(np.asarray(dz_t)[:n], dz_o),
                _rel_err(np.asarray(nu_t)[:n], nu_o))
    err_x = max(_rel_err(np.asarray(dz_x)[:n], dz_o),
                _rel_err(np.asarray(nu_x)[:n], nu_o))
    return {
        "d": d, "s": s, "T": T, "B": B, "dtype": dtype,
        "rel_err_triton": err_t,
        "rel_err_xla": err_x,
        "rtol": KKT_CHECK_RTOL,
        "precision": f"{dtype}, matmul precision {prec}",
        "ms_triton": 1e3 * ms_t,
        "ms_xla": 1e3 * ms_x,
        "ok": bool(
            err_t <= KKT_CHECK_RTOL and err_x <= KKT_CHECK_RTOL
            and np.asarray(ok_t).all() and np.asarray(ok_x).all()
        ),
    }
