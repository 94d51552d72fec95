"""Device-mesh utilities for batched gate synthesis.

Parallelism design (SURVEY.md §5/§7): gate-synthesis instances and multi-start
seeds are embarrassingly parallel — the scaling axis is the instance BATCH,
sharded over a flat 1-D device mesh (the cards of a host are joined all to
all, so the mesh follows the algorithm alone); the stage-wise KKT
factorization stays per-instance (never sharded), and the solve loop runs
under shard_map with no collectives at all.  This replaces the reference's
single-process Ipopt loop (no distributed backend exists upstream;
.github/workflows/CI.yml:20-27).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "batched_solve",
    "init_distributed",
    "make_global_batch",
]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
):
    """Multi-host (DCN) wiring: initialize the JAX distributed runtime so
    `jax.devices()` spans every host's chips and one `Mesh` covers the pod.

    Pass the coordinator address (`host:port`), the process count and this
    process's id unless the cluster environment provides them.  After this,
    a multi-host run is:

        init_distributed(...)
        mesh = make_mesh()                      # all global devices
        Z0 = make_global_batch(local_Z0, mesh)  # per-host shards -> global
        res = batched_solve(problem, Z0, mesh=mesh)

    Idempotent: a second call is a no-op.
    """
    # NOTE: must not call jax.process_count()/jax.devices() here — those
    # initialize the XLA backend, after which distributed.initialize()
    # refuses to run.  The idempotence check inspects the distributed
    # client state directly.
    if getattr(jax.distributed, "is_initialized", lambda: False)() or (
        getattr(jax.distributed, "global_state", None) is not None
        and getattr(jax.distributed.global_state, "client", None) is not None
    ):
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def make_global_batch(local_batch, mesh: Mesh, axis_name: str = "batch"):
    """Assemble a globally-sharded batch array from each process's local
    shard (multi-host analog of shard_batch): host k contributes rows
    [k*B_local, (k+1)*B_local) of the global batch."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sharding, x),
        local_batch,
    )


def make_mesh(n_devices: int | None = None, axis_name: str = "batch") -> Mesh:
    """1-D device mesh over the instance-batch axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_batch(tree, mesh: Mesh, axis_name: str = "batch"):
    """Shard every leaf's leading axis across the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree
    )


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree
    )


def _mesh_runners(solver, mesh, max_iter, axis_name):
    """(init, run) jitted for this solver, mesh and iteration count —
    built once and kept on the solver, so repeated solves reuse the
    compiled executables."""
    cache = solver.__dict__.setdefault("_mesh_runners", {})
    key = (mesh, max_iter, axis_name)
    if key not in cache:
        spec = P(axis_name)
        # batch-sharded out_shardings on the init: leaves created inside
        # (zeros, filters) would otherwise come out replicated, and a
        # post-hoc device_put reshard of replicated multi-process arrays
        # trips XLA's device-order reshard assertion
        init = jax.jit(
            solver.init_state, out_shardings=NamedSharding(mesh, spec)
        )
        # the per-shard all-converged exit is local to each device (no
        # collective inside shard_map) — except across processes, where
        # every process keeps the same fixed trip count
        early_exit = jax.process_count() == 1
        run = jax.jit(jax.shard_map(
            lambda st: solver._solve_loop_impl(st, max_iter, early_exit),
            mesh=mesh,
            in_specs=spec,
            out_specs=spec,
            check_vma=False,
        ))
        cache[key] = (init, run)
    return cache[key]


def batched_solve(problem, Z0, *, mesh: Mesh | None = None, max_iter=None,
                  axis_name: str = "batch"):
    """Solve a batch of initial decisions, sharded across a device mesh.

    problem: a QuantumControlProblem; Z0: (B, T, d_aug) with B divisible by
    the mesh size.

    The loop runs under shard_map with per-shard specs, so each device
    advances ITS instances with ZERO collectives during the solve (the IPM
    is element-wise over the batch; the data-dependent loop conditions —
    convergence vote, delta_w retry vote — are per shard).  That also keeps
    a custom kernel (the triton KKT backend) on each device's own shard.
    Per instance the iterates match the unsharded solve: converged
    instances freeze and a successful factorization attempt is never
    replaced, so a shard's extra loop trips change no instance.
    """
    if mesh is None:
        mesh = make_mesh()
    Z0 = shard_batch(Z0, mesh)
    solver = problem.solver
    import jax.numpy as jnp

    from ..solver.ipm import IPMResult

    max_iter = max_iter or solver.options.max_iter
    init, run = _mesh_runners(solver, mesh, max_iter, axis_name)
    state = run(init(Z0))
    obj = solver._batched_cost(state.Z)
    Z_out = (
        state.Z * jnp.asarray(solver.var_scale, state.Z.dtype)
        if solver.options.nlp_scaling
        else state.Z
    )
    return IPMResult(
        Z=Z_out, lam=state.lam, converged=state.converged,
        n_iter=state.n_iter, kkt_err=state.kkt_err, mu=state.mu,
        objective=obj,
    )
