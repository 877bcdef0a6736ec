"""GPU hardware tier: c64 numerics and native f64/c128 on the card.

Run on a machine with an NVIDIA GPU::

    MAUS_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu.py -q

(``chip_smoke.py`` runs the same command in-process.) Every test here
exercises behavior the CPU tier cannot: c64 convergence floors with f64
refinement on the card, the native c128 residual, checkpointing
device-resident complex state, and the device cond probe. Whether a card is
present is decided in a fixture; without one every test skips.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu

N = 64          # the tier's single square shape — reused to bound compiles
K = 8


@pytest.fixture(autouse=True)
def _gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (MAUS_GPU_TESTS=1 pytest -m gpu)")


def _host_problem(seed=0, cond=100.0):
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((N, N))
                         + 1j * rng.standard_normal((N, N)))
    q2, _ = np.linalg.qr(rng.standard_normal((N, N))
                         + 1j * rng.standard_normal((N, N)))
    s = np.logspace(0, -np.log10(cond), N)
    A = (q1 * s[None, :]) @ q2.conj().T
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    return A, b


class TestBackend:
    def test_capabilities_on_card(self):
        from maus_tpu.core import backend

        assert backend.platform() == "gpu"
        assert backend.native_f64() and backend.complex_host_transfer()
        assert not backend.branch_memory_cap()
        assert backend.device_memory_bytes() > 1 << 30
        assert backend.default_complex_dtype() == jnp.complex64


class TestNativeResidual:
    def test_c128_residual_matches_numpy(self):
        """The refinement's true residual runs in native f64 on the card:
        agreement with numpy to f64 summation roundoff (|Δr|∞ ≤ 8·N·ε·‖A‖∞
        ‖x‖∞ — both sides sum in different orders)."""
        from maus_tpu.ops.refine import SplitComplex, make_true_resid

        rng = np.random.default_rng(1)
        A = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
        b = rng.standard_normal(N) + 1j * rng.standard_normal(N)

        def sc(z):
            return SplitComplex(jnp.asarray(z.real), jnp.asarray(z.imag))

        r = jax.jit(lambda a, xx, bb: make_true_resid(a, bb)(xx))(
            sc(A), sc(x), sc(b))
        r = np.asarray(r.re) + 1j * np.asarray(r.im)
        bound = 8 * N * np.finfo(np.float64).eps \
            * np.abs(A).sum(axis=1).max() * np.abs(x).max()
        assert np.max(np.abs(r - (b - A @ x))) <= bound


class TestLinearFloor:
    def test_solve_reaches_1e8_via_refinement(self):
        import maus_tpu
        from maus_tpu.core.types import ProblemType

        A, b = _host_problem(seed=0, cond=1e3)
        s = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                                initial_num_candidates=K)
        assert s.config.dtype == jnp.complex64
        rep = s.evolve(max_iterations=40)
        assert rep.converged
        assert rep.residuals[0] <= 1e-8
        # the refined solution must actually solve the ORIGINAL host system
        x = rep.solutions[0][0]
        rel = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert rel <= 1e-8

    def test_device_resident_operand_solve(self):
        """A jax.Array operand goes through MausSolver with zero host
        round-trip (device diagnosis + device rhs)."""
        import maus_tpu
        from maus_tpu.core.types import ProblemType

        A, b = _host_problem(seed=8, cond=1e3)
        Ad = jnp.asarray(A, jnp.complex64)
        bd = jnp.asarray(b, jnp.complex64)
        s = maus_tpu.MausSolver(Ad, ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=bd, initial_num_candidates=K)
        assert s.A_host is None and s.b_host is None
        rep = s.evolve(40)
        x = rep.solutions[0][0]
        A64 = np.asarray(Ad).astype(np.complex128)
        b64 = np.asarray(bd).astype(np.complex128)
        assert np.linalg.norm(A64 @ x - b64) / np.linalg.norm(b64) < 1e-8


class TestEigFloor:
    def test_hermitian_eig_reaches_1e8(self):
        import maus_tpu
        from maus_tpu.core.types import ProblemType

        rng = np.random.default_rng(1)
        B = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        Ah = (B + B.conj().T) / 2
        s = maus_tpu.MausSolver(Ah, ProblemType.EIGENVALUE,
                                initial_num_candidates=2 * K,
                                global_convergence_tol=1e-8)
        rep = s.evolve(max_iterations=40)
        assert rep.num_distinct >= K          # capacity-bounded coverage
        anorm = float(np.linalg.norm(Ah, 2))
        assert max(rep.residuals) <= 1e-8 * max(anorm, 1.0)
        w_true = np.linalg.eigvalsh(Ah)
        for lam, _v in rep.solutions:
            assert np.min(np.abs(w_true - lam)) < 1e-6 * anorm

    def test_nonhermitian_eig_hessenberg_path(self):
        """Non-Hermitian eig through the production path: shared Hessenberg
        reduction + the batched Givens sweep, finished to 1e-8 by the Newton
        refiner."""
        import maus_tpu
        from maus_tpu.core.types import ProblemType, SolverConfig

        rng = np.random.default_rng(7)
        n = 128
        A = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
        cfg = SolverConfig(problem_type=ProblemType.EIGENVALUE,
                           num_candidates=16, tol=1e-8, dtype=jnp.complex64,
                           convergence_floor=5e-6,
                           target_num_solutions=4)
        s = maus_tpu.MausSolver(A, ProblemType.EIGENVALUE, config=cfg)
        rep = s.evolve(max_iterations=60)
        assert rep.num_distinct >= 4
        w_true = np.linalg.eigvals(A)
        anorm = float(np.abs(w_true).max())
        assert max(rep.residuals) <= 1e-8 * max(anorm, 1.0) * 10
        for lam, v in rep.solutions:
            assert np.min(np.abs(w_true - lam)) < 1e-5 * anorm
            assert np.linalg.norm(A @ v - lam * v) <= 1e-7 * max(anorm, 1.0)


class TestSvdFloor:
    def test_svd_reaches_1e6(self):
        import maus_tpu
        from maus_tpu.core.types import ProblemType
        from maus_tpu.problems import generators as gen

        A = np.asarray(gen.low_rank_svd_matrix(5, 4, seed=0))
        s = maus_tpu.MausSolver(A, ProblemType.SVD, initial_num_candidates=12,
                                global_convergence_tol=1e-6)
        rep = s.evolve(max_iterations=60)
        sig = sorted((t[0] for t in rep.solutions), reverse=True)
        assert np.isclose(sig[0], 5.0, rtol=1e-4)
        assert np.isclose(sig[1], 2.5, rtol=1e-4)
        for (sg, u, v), r in zip(rep.solutions, rep.residuals):
            if sg > 1e-3:
                two_sided = np.linalg.norm(A @ v - sg * u) \
                    + np.linalg.norm(A.conj().T @ u - sg * v)
                assert r <= 1e-6 and two_sided <= 1e-6


class TestSharedEigh:
    def test_eigh_accuracy_on_card(self):
        """XLA eigh in c64 at HIGHEST matmul precision vs f64 host oracle."""
        from maus_tpu.solver.hermitian import eigh_setup

        rng = np.random.default_rng(2)
        B = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
        Ah = (B + B.conj().T) / 2
        cache = eigh_setup(jnp.asarray(Ah, jnp.complex64))
        w = np.asarray(cache.w)
        V = np.asarray(cache.V)
        w_true = np.linalg.eigvalsh(Ah)
        anorm = float(np.abs(w_true).max())
        assert np.max(np.abs(np.sort(w) - w_true)) < 5e-5 * anorm
        r = Ah @ V - V * w[None, :]
        assert np.max(np.linalg.norm(r, axis=0)) < 5e-5 * anorm


class TestCheckpointOnCard:
    def test_roundtrip_with_complex_device_state(self, tmp_path):
        """save/load of the full carry (complex population + factors): the
        restored carry steps bit-identically to the original."""
        import maus_tpu
        from maus_tpu.core.types import ProblemType
        from maus_tpu.solver import evolve as ev
        from maus_tpu.utils import checkpoint

        A, b = _host_problem(seed=3, cond=10.0)
        s = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                                initial_num_candidates=K)
        cfg, kn = s.config, s.knowledge

        @jax.jit
        def step(A_, b_, carry_):
            return ev.make_iteration(cfg, kn, A_, b_, None, 1)(carry_)

        carry = ev.init_carry(cfg, kn, s.A, s._key)
        carry, _ = step(s.A, s.b, carry)
        path = str(tmp_path / "gpu_ckpt.npz")
        n_leaves = checkpoint.save_state(path, carry)
        assert n_leaves > 5
        template = ev.init_carry(cfg, kn, s.A, s._key)
        loaded = checkpoint.load_state(path, template)
        ref, _ = step(s.A, s.b, carry)
        res, _ = step(s.A, s.b, loaded)
        np.testing.assert_array_equal(np.asarray(ref.pop.v),
                                      np.asarray(res.pop.v))

        # the ABSTRACT (eval_shape) template restores identically too
        template2 = jax.eval_shape(
            lambda a, k_: ev.init_carry(cfg, kn, a, k_), s.A, s._key)
        loaded2 = checkpoint.load_state(path, template2)
        res2, _ = step(s.A, s.b, loaded2)
        np.testing.assert_array_equal(np.asarray(ref.pop.v),
                                      np.asarray(res2.pop.v))


class TestCondProbe:
    def test_device_cond_estimate_on_card(self):
        from maus_tpu.solver.diagnose import estimate_cond_device

        A, _ = _host_problem(seed=4, cond=1e4)
        c = estimate_cond_device(jnp.asarray(A, jnp.complex64))
        assert 2e3 <= c <= 5e4
