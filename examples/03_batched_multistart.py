"""Batched multi-start gate synthesis — the batch as the scaling axis.

Thousands of rollout-consistent seeds advance in lockstep through the batched
interior-point method; the whole batch is one jit-compiled while_loop, and
the batch axis shards across a device mesh (see quantumcollocation_tpu.parallel).
"""

import numpy as np

import quantumcollocation_tpu as qct


def main():
    # CNOT via cross-resonance-style controls
    ZX = np.kron(qct.PAULIS["Z"], qct.PAULIS["X"])
    XI = np.kron(qct.PAULIS["X"], qct.PAULIS["I"])
    YI = np.kron(qct.PAULIS["Y"], qct.PAULIS["I"])
    IX = np.kron(qct.PAULIS["I"], qct.PAULIS["X"])
    IY = np.kron(qct.PAULIS["I"], qct.PAULIS["Y"])
    system = qct.QuantumSystem(
        0.1 * np.kron(qct.PAULIS["Z"], qct.PAULIS["Z"]),
        [ZX, XI, YI, IX, IY],
    )

    prob = qct.UnitarySmoothPulseProblem(
        system, qct.GATES["CX"], 40, 0.3,
        ipopt_options=qct.SolverOptions(print_level=3, tol=1e-6),
        piccolo_options=qct.PiccoloOptions(verbose=False),
    )
    prob.solve_multistart(n_seeds=8, sigma=0.3, rng=np.random.default_rng(0))
    print("best-seed CNOT fidelity:",
          float(qct.unitary_rollout_fidelity(prob.trajectory, system)))


if __name__ == "__main__":
    main()
