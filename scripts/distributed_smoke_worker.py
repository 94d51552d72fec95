"""Worker process for the 2-process jax.distributed CPU smoke test.

Launched (twice) by tests/test_distributed.py.  Each process contributes 2
virtual CPU devices; the pair forms one 4-device global mesh over the
instance-batch axis — the exact multi-host wiring a real pod run uses
(parallel/mesh.py::init_distributed docstring), over localhost TCP.

argv: <coordinator_port> <process_id> <num_processes>
Prints one JSON line with per-process results; exit code 0 on success.
"""

import json
import os
import sys

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

# initialize the distributed runtime BEFORE anything can touch the XLA
# backend (jax.distributed.initialize refuses to run afterwards)
from quantumcollocation_tpu.parallel import init_distributed  # noqa: E402

init_distributed(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)

import quantumcollocation_tpu as qct  # noqa: E402
from quantumcollocation_tpu.parallel import (  # noqa: E402
    batched_solve,
    make_global_batch,
    make_mesh,
)


def main():
    assert jax.process_count() == nproc, jax.process_count()
    n_global = len(jax.devices())
    assert n_global == 2 * nproc, n_global

    sys_q = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])
    prob = qct.UnitarySmoothPulseProblem(
        sys_q, qct.GATES["H"], 11, 0.2,
        ipopt_options=qct.SolverOptions(print_level=1, tol=1e-5),
        piccolo_options=qct.PiccoloOptions(verbose=False),
        rng=np.random.default_rng(0),
    )
    mesh = make_mesh()  # all global devices
    B_local = 4
    # every process derives the same global batch deterministically and
    # contributes its own rows — the multi-host data-feeding pattern
    Z_all = prob.multistart_initial_decisions(
        B_local * nproc, sigma=0.1, rng=np.random.default_rng(7)
    )
    local_rows = np.asarray(
        Z_all[pid * B_local : (pid + 1) * B_local], dtype=np.float64
    )
    Z0 = make_global_batch(local_rows, mesh)
    assert Z0.shape[0] == B_local * nproc

    res = batched_solve(prob, Z0, mesh=mesh, max_iter=12)
    jax.block_until_ready(res.Z)

    # per-process view of the global result: addressable shard rows
    obj_local = [
        float(np.asarray(sh.data).reshape(-1)[0])
        for sh in res.objective.addressable_shards
    ]
    kkt_local = [
        float(np.asarray(sh.data).reshape(-1)[0])
        for sh in res.kkt_err.addressable_shards
    ]
    out = {
        "process": pid,
        "processes": jax.process_count(),
        "global_devices": n_global,
        "obj_local": obj_local,
        "kkt_local": kkt_local,
        "ok": all(np.isfinite(obj_local)) and all(np.isfinite(kkt_local)),
    }
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
