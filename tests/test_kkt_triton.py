"""Triton KKT kernels (interpret mode on the CPU; lowering for CUDA checked
here too), the backend-dispatch policy, and the XLA KKT path against the
f64 native oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quantumcollocation_tpu as qct
from quantumcollocation_tpu.ops.native import kkt_solve_native
from quantumcollocation_tpu.solver.ipm import resolve_kkt_backend
from quantumcollocation_tpu.solver.kkt import (
    factor_kkt,
    solve_kkt,
    solve_with_factors,
)
from quantumcollocation_tpu.solver.kkt_check import (
    KKT_CHECK_RTOL,
    check_kkt_backends,
    random_kkt_blocks,
)
from quantumcollocation_tpu.solver.kkt_triton import (
    resolve_kkt_triton,
    solve_kkt_triton,
    tile_dim,
)

DC = 1e-8


def _xla(H, C, A, B, rz, rnu):
    return jax.vmap(lambda *a: solve_kkt(*a, DC))(H, C, A, B, rz, rnu)


def _blocks(B=3, T=6, d=5, s=3, seed=0):
    return [jnp.asarray(x) for x in random_kkt_blocks(B, T, d, s, seed)]


class TestTritonKernel:
    @pytest.mark.parametrize("d,s", [(5, 3), (15, 13), (20, 18), (33, 30)])
    def test_matches_solve_kkt(self, d, s):
        # tiles 16, 16, 32, 64: padding of every power-of-two class
        args = _blocks(B=3, T=5, d=d, s=s, seed=d)
        dz, nu, ok = solve_kkt_triton(*args, DC, interpret=True)
        dz_r, nu_r, _ = _xla(*args)
        assert bool(ok.all())
        assert dz.shape == dz_r.shape and nu.shape == nu_r.shape
        np.testing.assert_allclose(np.asarray(dz), np.asarray(dz_r), atol=1e-9)
        np.testing.assert_allclose(np.asarray(nu), np.asarray(nu_r), atol=1e-9)

    def test_short_horizon(self):
        args = _blocks(B=2, T=2, d=4, s=2, seed=5)
        dz, nu, ok = solve_kkt_triton(*args, DC, interpret=True)
        dz_r, nu_r, _ = _xla(*args)
        np.testing.assert_allclose(np.asarray(dz), np.asarray(dz_r), atol=1e-10)
        np.testing.assert_allclose(np.asarray(nu), np.asarray(nu_r), atol=1e-10)

    def test_odd_batch(self):
        # one program per instance: any batch size, no batch padding
        args = _blocks(B=5, T=4, d=6, s=4, seed=7)
        dz, nu, ok = solve_kkt_triton(*args, DC, interpret=True)
        assert dz.shape[0] == 5 and bool(ok.all())
        np.testing.assert_allclose(
            np.asarray(dz), np.asarray(_xla(*args)[0]), atol=1e-10
        )

    def test_resolve_with_kept_factors(self):
        # a NEW rhs against the kept factors == a fresh factor + solve
        H, C, A, B, rz, rnu = _blocks(B=2, T=6, d=7, s=5, seed=3)
        _, _, _, fac = solve_kkt_triton(
            H, C, A, B, rz, rnu, DC, interpret=True, want_factors=True
        )
        rng = np.random.default_rng(9)
        rz2 = jnp.asarray(rng.standard_normal(rz.shape))
        rnu2 = jnp.asarray(rng.standard_normal(rnu.shape))
        dz, nu, ok = resolve_kkt_triton(fac, rz2, rnu2, interpret=True)
        dz_r, nu_r, _ = _xla(H, C, A, B, rz2, rnu2)
        assert bool(ok.all())
        np.testing.assert_allclose(np.asarray(dz), np.asarray(dz_r), atol=1e-10)
        np.testing.assert_allclose(np.asarray(nu), np.asarray(nu_r), atol=1e-10)

    def test_multi_column_rhs(self):
        # 3 columns are padded to a 16-wide product; each column must equal
        # its own single-column solve
        H, C, A, B, _, _ = _blocks(B=2, T=5, d=6, s=4, seed=4)
        rng = np.random.default_rng(1)
        RZ = jnp.asarray(rng.standard_normal((2, 5, 6, 3)))
        RNU = jnp.asarray(rng.standard_normal((2, 4, 4, 3)))
        DZ, NU, ok = solve_kkt_triton(H, C, A, B, RZ, RNU, DC, interpret=True)
        assert DZ.shape == (2, 5, 6, 3) and NU.shape == (2, 4, 4, 3)
        for k in range(3):
            dz_k, nu_k, _ = _xla(H, C, A, B, RZ[..., k], RNU[..., k])
            np.testing.assert_allclose(
                np.asarray(DZ[..., k]), np.asarray(dz_k), atol=1e-10
            )
            np.testing.assert_allclose(
                np.asarray(NU[..., k]), np.asarray(nu_k), atol=1e-10
            )

    def test_indefinite_block_reports_not_ok(self):
        H, C, A, B, rz, rnu = _blocks(B=2, T=4, d=5, s=3, seed=2)
        H = H.at[1, 2].set(-jnp.eye(5))  # instance 1: knot 2 indefinite
        _, _, ok = solve_kkt_triton(H, C, A, B, rz, rnu, DC, interpret=True)
        _, _, ok_x = _xla(H, C, A, B, rz, rnu)
        assert bool(ok[0]) and not bool(ok[1])
        assert np.array_equal(np.asarray(ok), np.asarray(ok_x))

    def test_check_against_oracle_interpret(self):
        # the chip_smoke phase-2 check, in f32 at a small size
        r = check_kkt_backends(15, 13, 6, 3, interpret=True, repeats=1)
        assert r["ok"], r
        assert r["rel_err_triton"] <= KKT_CHECK_RTOL

    @pytest.mark.parametrize("d,s,T", [(15, 13, 51), (28, 22, 40), (47, 42, 40)])
    def test_lowers_for_cuda(self, d, s, T):
        # the kernels lower to Triton IR at the bench widths (power-of-two
        # tiles, supported primitives) — the GPU's own compiler runs only
        # on the card (chip_smoke.py phase 2)
        def sds(*shape):
            return jax.ShapeDtypeStruct(shape, jnp.float32)

        def f(H, C, A, B, rz, rnu, RZ, RNU):
            dz, nu, _, fac = solve_kkt_triton(
                H, C, A, B, rz, rnu, DC, want_factors=True
            )
            return dz, nu, resolve_kkt_triton(fac, RZ, RNU)

        Bt, k = 4, 13
        lowered = jax.jit(f).trace(
            sds(Bt, T, d, d), sds(Bt, T - 1, d, d), sds(Bt, T - 1, s, d),
            sds(Bt, T - 1, s, d), sds(Bt, T, d), sds(Bt, T - 1, s),
            sds(Bt, T, d, k), sds(Bt, T - 1, s, k),
        ).lower(lowering_platforms=("cuda",))
        assert lowered.as_text().count("xla.gpu.triton") == 4

    def test_tile_dims(self):
        assert [tile_dim(n) for n in (1, 15, 16, 17, 33, 64)] == [
            16, 16, 16, 32, 64, 64
        ]


def _hadamard(backend, T=11, **kw):
    sys = qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]])
    return qct.UnitarySmoothPulseProblem(
        sys, qct.GATES["H"], T, 0.2,
        ipopt_options=qct.SolverOptions(
            print_level=1, tol=1e-7, kkt_backend=backend,
            kkt_interpret=backend == "triton", **kw.pop("opts", {}),
        ),
        piccolo_options=qct.PiccoloOptions(verbose=False, **kw),
        rng=np.random.default_rng(0),
    ), sys


class TestTritonSolver:
    @pytest.mark.parametrize(
        "opts,piccolo,iters",
        [
            ({"soc": True}, {}, 12),          # kept factors + rhs re-solve
            ({"kkt_refine": 1}, {}, 12),      # refinement through kept factors
            ({}, {"eval_hessian": False}, 15),  # L-BFGS multi-column SMW
        ],
        ids=["soc", "refine", "lbfgs"],
    )
    def test_tracks_xla_backend(self, opts, piccolo, iters):
        objs = {}
        for backend in ("xla", "triton"):
            prob, _ = _hadamard(backend, opts=opts, **piccolo)
            res = prob.solver.solve(prob.initial_decision(2), max_iter=iters)
            objs[backend] = float(res.objective[0])
        assert abs(objs["xla"] - objs["triton"]) < 1e-8 * max(
            1.0, abs(objs["xla"])
        )

    def test_full_solve_with_triton_backend(self):
        prob_x, sys = _hadamard("xla", T=21)
        prob_t, _ = _hadamard("triton", T=21)
        prob_x.solve(max_iter=40)
        prob_t.solve(max_iter=40)
        f_x = float(qct.unitary_rollout_fidelity(prob_x.trajectory, sys))
        f_t = float(qct.unitary_rollout_fidelity(prob_t.trajectory, sys))
        assert abs(f_x - f_t) < 1e-6
        assert f_t > 0.8


class TestDispatchPolicy:
    def test_auto_is_xla_off_the_gpu(self):
        assert jax.default_backend() == "cpu"
        for d in (15, 47, 300):
            assert resolve_kkt_backend(qct.SolverOptions(), d, d) == "xla"

    def test_triton_needs_a_gpu_or_explicit_interpret(self):
        with pytest.raises(ValueError, match="CUDA GPU"):
            resolve_kkt_backend(qct.SolverOptions(kkt_backend="triton"), 15, 13)
        opts = qct.SolverOptions(kkt_backend="triton", kkt_interpret=True)
        assert resolve_kkt_backend(opts, 15, 13) == "triton"

    def test_triton_rejects_stages_above_tile_limit(self):
        opts = qct.SolverOptions(kkt_backend="triton", kkt_interpret=True)
        with pytest.raises(ValueError, match="stage dims"):
            resolve_kkt_backend(opts, 65, 40)

    def test_explicit_xla_and_cr_pass_through(self):
        for b in ("xla", "cr"):
            assert resolve_kkt_backend(
                qct.SolverOptions(kkt_backend=b), 100, 90
            ) == b


class TestXLAKKTOracle:
    """The XLA Riccati path against the f64 native oracle at the bench's
    stage widths (f64 here, so the tolerance is tight)."""

    @pytest.mark.parametrize("d,s", [(15, 13), (28, 22), (47, 42)])
    @pytest.mark.parametrize("case", ["single", "multi", "resolve"])
    def test_matches_native(self, d, s, case):
        H, C, A, B, rz, rnu = random_kkt_blocks(1, 6, d, s, seed=d)
        H, C, A, B, rz, rnu = H[0], C[0], A[0], B[0], rz[0], rnu[0]
        rng = np.random.default_rng(d + 1)
        fac = factor_kkt(*(jnp.asarray(x) for x in (H, C, A, B)), DC)
        if case == "single":
            cols = [(rz, rnu)]
            dz, nu, ok = solve_kkt(
                *(jnp.asarray(x) for x in (H, C, A, B, rz, rnu)), DC
            )
            outs = [(dz, nu)]
        elif case == "multi":
            RZ = rng.standard_normal(rz.shape + (3,))
            RNU = rng.standard_normal(rnu.shape + (3,))
            DZ, NU, ok = solve_with_factors(
                fac, jnp.asarray(RZ), jnp.asarray(RNU)
            )
            cols = [(RZ[..., k], RNU[..., k]) for k in range(3)]
            outs = [(DZ[..., k], NU[..., k]) for k in range(3)]
        else:
            rz2 = rng.standard_normal(rz.shape)
            rnu2 = rng.standard_normal(rnu.shape)
            dz, nu, ok = solve_with_factors(
                fac, jnp.asarray(rz2), jnp.asarray(rnu2)
            )
            cols, outs = [(rz2, rnu2)], [(dz, nu)]
        assert bool(ok)
        for (r1, r2), (dz, nu) in zip(cols, outs):
            dz_o, nu_o, ok_o = kkt_solve_native(H, C, A, B, r1, r2, DC)
            assert ok_o
            np.testing.assert_allclose(np.asarray(dz), dz_o, rtol=1e-8,
                                       atol=1e-10)
            np.testing.assert_allclose(np.asarray(nu), nu_o, rtol=1e-8,
                                       atol=1e-10)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a CUDA GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run: QCT_TEST_PLATFORM=gpu "
                    "python -m pytest -m gpu tests/)")


@pytest.mark.gpu
@pytest.mark.parametrize("d,s,T,B", [(15, 13, 51, 512), (28, 22, 40, 256),
                                     (47, 42, 40, 128)])
def test_triton_kernel_on_gpu(gpu, d, s, T, B):
    r = check_kkt_backends(d, s, T, B)
    assert r["ok"], r
