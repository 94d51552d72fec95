"""BASELINE.json canonical configs as regression tests.

Configs (BASELINE.json / BASELINE.md):
  #1 single-qubit Hadamard T=51 dt=0.2  (covered by test_unitary_smooth_pulse)
  #2 minimum-time with fidelity floor    (covered by test_problem_templates)
  #3 two-qubit CNOT smooth pulse (4x4 unitary, cross-resonance-style drives)
  #4 transmon-with-leakage gate synthesis (3-level template + leakage
     suppression objective)
  #5 two-transmon embedded CZ (the reference's robustness-problem canonical
     config, /root/reference/src/problem_templates/
     unitary_robustness_problem.jl:184-207: 2x 3-level transmons, dipole
     coupling, CZ on the qubit subspace)
"""

import numpy as np
import pytest

import quantumcollocation_tpu as qct
from quantumcollocation_tpu.systems import TransmonSystem

TOL = qct.SolverOptions(print_level=1, tol=1e-6)
QUIET = qct.PiccoloOptions(verbose=False)


class TestTwoQubitCNOT:
    def test_cnot_synthesis(self):
        # cross-resonance-style control set: ZX drive plus full local drives.
        # (Without YI the reachable set caps at F = 1/sqrt(2) for CX —
        # verified independently by unconstrained GRAPE.)
        ZX = np.kron(qct.PAULIS["Z"], qct.PAULIS["X"])
        XI = np.kron(qct.PAULIS["X"], qct.PAULIS["I"])
        YI = np.kron(qct.PAULIS["Y"], qct.PAULIS["I"])
        IX = np.kron(qct.PAULIS["I"], qct.PAULIS["X"])
        IY = np.kron(qct.PAULIS["I"], qct.PAULIS["Y"])
        H_drift = 0.1 * np.kron(qct.PAULIS["Z"], qct.PAULIS["Z"])
        sys = qct.QuantumSystem(H_drift, [ZX, XI, YI, IX, IY])

        prob = qct.UnitarySmoothPulseProblem(
            sys, qct.GATES["CX"], 40, 0.3,
            ipopt_options=TOL,
            piccolo_options=QUIET,
            rng=np.random.default_rng(7),
        )
        initial = float(qct.unitary_rollout_fidelity(prob.trajectory, sys))
        # batched multi-start with rollout-consistent seeds (the batched
        # answer to landscape nonconvexity)
        prob.solve_multistart(n_seeds=4, sigma=0.3,
                              rng=np.random.default_rng(3), max_iter=60)
        final = float(qct.unitary_rollout_fidelity(prob.trajectory, sys))
        assert final > initial
        assert final > 0.9


class TestTwoTransmonEmbeddedCZ:
    def test_embedded_cz_synthesis(self):
        # the reference's robustness canonical config, scaled to CI size
        # (T=75 dt=1.0 upstream; T=25 here — the embedded-subspace machinery
        # and the composite dims are what the config exercises)
        sys = qct.MultiTransmonSystem(
            omegas=[4.0, 4.5],
            deltas=[0.2, 0.2],
            gs=[[0.0, 0.01], [0.01, 0.0]],
            levels_per_transmon=3,
        )
        U_goal = qct.EmbeddedOperator(qct.GATES["CZ"], sys)
        prob = qct.UnitarySmoothPulseProblem(
            sys, U_goal, 25, 1.0,
            a_bound=0.1,
            ipopt_options=TOL,
            piccolo_options=qct.PiccoloOptions(verbose=False),
            rng=np.random.default_rng(5),
        )
        initial = float(
            qct.unitary_rollout_fidelity(
                prob.trajectory, sys, subspace=U_goal.subspace
            )
        )
        prob.solve(max_iter=25)
        final = float(
            qct.unitary_rollout_fidelity(
                prob.trajectory, sys, subspace=U_goal.subspace
            )
        )
        assert final > initial


class TestTransmonLeakage:
    def test_three_level_transmon_leakage_suppression(self):
        sys = TransmonSystem(omega=4.0, delta=0.2, levels=3)
        U_goal = qct.EmbeddedOperator(qct.GATES["X"], sys)
        # fixed time: the free-time + L1-slack + 2pi-stiff-generator combo
        # needs NLP variable scaling (tracked for the solver roadmap); the
        # fixed-time problem solves to ~0.99 subspace fidelity
        prob = qct.UnitarySmoothPulseProblem(
            sys, U_goal, 40, 0.1,
            a_bound=0.5,
            ipopt_options=TOL,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, leakage_suppression=True, R_leakage=1e-1,
                free_time=False,
            ),
            rng=np.random.default_rng(11),
        )
        assert any("l1_slack" in n for n in prob.trajectory.names)
        initial = float(
            qct.unitary_rollout_fidelity(
                prob.trajectory, sys, subspace=U_goal.subspace
            )
        )
        prob.solve(max_iter=70)
        final = float(
            qct.unitary_rollout_fidelity(
                prob.trajectory, sys, subspace=U_goal.subspace
            )
        )
        assert final > initial
        assert final > 0.9

        # comparative behavioral check: the L1 leakage term reduces the
        # time-summed leakage amplitudes vs the unsuppressed problem
        def total_leakage(p):
            iso_leak = qct.get_iso_vec_leakage_indices(U_goal)
            U = np.asarray(p.trajectory["Ũ⃗"])
            return float(np.linalg.norm(U[:, iso_leak]))

        plain = qct.UnitarySmoothPulseProblem(
            sys, U_goal, 40, 0.1,
            a_bound=0.5,
            ipopt_options=TOL,
            piccolo_options=qct.PiccoloOptions(
                verbose=False, free_time=False
            ),
            rng=np.random.default_rng(11),
        )
        plain.solve(max_iter=70)
        # strict decrease (reference-strength assertion; measured ratio ~0.66
        # at this config, scripts/calibrate_behavior_tests.py)
        assert total_leakage(prob) < total_leakage(plain)
