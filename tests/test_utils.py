"""Tests for aux subsystems: checkpoint/resume, metrics sink, truth comparison,
and the CLI (SURVEY.md §5)."""
import io
import json

import jax
import numpy as np
import pytest

import maus_tpu
from maus_tpu.core.types import ProblemType
from maus_tpu.problems import generators as gen
from maus_tpu.solver import evolve as ev
from maus_tpu.utils import checkpoint, metrics, truth


class TestCheckpoint:
    def test_save_load_roundtrip_and_resume(self, tmp_path):
        """Checkpoint mid-run, resume from the file, match the uninterrupted run
        exactly (the whole point of the carry being one pytree, SURVEY §5.4)."""
        A_h, b_h = gen.well_conditioned_system(32, seed=0)
        s = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b_h,
                                initial_num_candidates=8)
        cfg, kn = s.config, s.knowledge
        step = jax.jit(ev.make_iteration(cfg, kn, s.A, s.b, None, 1))
        carry = ev.init_carry(cfg, kn, s.A, s._key)

        for _ in range(3):
            carry, _ = step(carry)
        path = str(tmp_path / "ckpt.npz")
        checkpoint.save_state(path, carry)

        # uninterrupted continuation
        ref = carry
        for _ in range(3):
            ref, _ = step(ref)

        # resumed continuation
        template = ev.init_carry(cfg, kn, s.A, s._key)
        loaded = checkpoint.load_state(path, template)
        for _ in range(3):
            loaded, _ = step(loaded)

        np.testing.assert_array_equal(np.asarray(ref.pop.v),
                                      np.asarray(loaded.pop.v))
        np.testing.assert_array_equal(np.asarray(ref.pop.status),
                                      np.asarray(loaded.pop.status))

    def test_legacy_carry_without_refactor_psi_resumes(self, tmp_path):
        """A checkpoint written before EvolveCarry gained its trailing
        refactor_psi scalar loads against the new template with the field
        defaulted to 0 (no pending host refactorization)."""
        A_h, b_h = gen.well_conditioned_system(32, seed=0)
        s = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=b_h, initial_num_candidates=8)
        cfg, kn = s.config, s.knowledge
        carry = ev.init_carry(cfg, kn, s.A, s._key)
        path = str(tmp_path / "legacy.npz")
        checkpoint.save_state(path, carry)
        # strip the final leaf (refactor_psi) and mark the file as the v2
        # format, simulating a checkpoint written before the field existed
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        n_leaves = len(jax.tree.leaves(carry))
        last = f"leaf_{n_leaves - 1:04d}"
        assert last in arrays
        del arrays[last]
        arrays["__version__"] = np.asarray(2, np.int64)
        np.savez(path, **arrays)
        template = ev.init_carry(cfg, kn, s.A, s._key)
        loaded = checkpoint.load_state(path, template)
        assert float(loaded.refactor_psi) == 0.0
        np.testing.assert_array_equal(np.asarray(loaded.pop.v),
                                      np.asarray(carry.pop.v))
        # the SAME truncation in a current-format file is corruption and
        # must stay loud (the pad is gated on the file's version stamp)
        arrays["__version__"] = np.asarray(3, np.int64)
        np.savez(path, **arrays)
        with pytest.raises(ValueError, match="leaves"):
            checkpoint.load_state(path, template)

    def test_shape_mismatch_fails_loudly(self, tmp_path):
        path = str(tmp_path / "bad.npz")
        checkpoint.save_state(path, {"a": np.zeros(3)})
        with pytest.raises(ValueError, match="shape"):
            checkpoint.load_state(path, {"a": np.zeros(4)})
        checkpoint.save_state(path, {"a": np.zeros(3)})
        with pytest.raises(ValueError, match="leaves"):
            checkpoint.load_state(path, {"a": np.zeros(3), "b": np.zeros(1)})

    def test_checkpoint_every_resume_bit_exact(self, tmp_path):
        """Kill a run mid-way (simulated by a small max_iterations), resume from
        the periodic checkpoint, and match the uninterrupted run bit-exactly
        (VERDICT r1 #8)."""
        A_h, b_h = gen.ill_conditioned_system(24, cond=1e4, seed=3)
        path = str(tmp_path / "periodic.npz")

        s_ref = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM,
                                    b_vector=b_h, initial_num_candidates=6)
        rep_ref = s_ref.evolve(max_iterations=6)

        s_a = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=b_h, initial_num_candidates=6)
        s_a.evolve(max_iterations=4, checkpoint_path=path, checkpoint_every=2)
        s_b = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM,
                                  b_vector=b_h, initial_num_candidates=6)
        rep_b = s_b.evolve(max_iterations=6, resume_from=path)

        assert rep_ref.iterations == rep_b.iterations
        assert rep_ref.residuals == rep_b.residuals
        np.testing.assert_array_equal(rep_ref.solutions[0][0],
                                      rep_b.solutions[0][0])

    def test_param_history_capture(self):
        """cfg.capture_param_history returns the per-iteration solution
        iterates (reference param_history, AMS:126/142-143)."""
        from maus_tpu.core.types import SolverConfig

        A_h, b_h = gen.well_conditioned_system(12, seed=2)
        cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                           num_candidates=4, capture_param_history=True,
                           dtype=np.complex128)
        s = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=b_h, config=cfg)
        rep = s.evolve(max_iterations=5, collect_metrics=True)
        ph = rep.metrics["candidate_params"]
        assert ph.shape == (5, 4, 12)
        # the trajectory must move and end finite
        assert np.all(np.isfinite(ph[-1].real))
        assert not np.allclose(ph[0], ph[-1])

    def test_dtype_mismatch_fails_loudly(self, tmp_path):
        """A checkpoint written under a different precision config must refuse
        to load (silent truncation was ADVICE r1 finding #5)."""
        path = str(tmp_path / "prec.npz")
        checkpoint.save_state(path, {"a": np.zeros(3, np.float64)})
        with pytest.raises(ValueError, match="dtype"):
            checkpoint.load_state(path, {"a": np.zeros(3, np.float32)})
        checkpoint.save_state(path, {"z": np.zeros(3, np.complex128)})
        with pytest.raises(ValueError, match="dtype"):
            checkpoint.load_state(path, {"z": np.zeros(3, np.complex64)})

    def test_complex_leaves_stored_as_split_planes(self, tmp_path):
        """Complex leaves go through utils/xfer — the file stores re/im
        planes."""
        path = str(tmp_path / "cplx.npz")
        z = (np.arange(6, dtype=np.float64)
             + 1j * np.arange(6, dtype=np.float64)).reshape(2, 3)
        checkpoint.save_state(path, {"z": z, "r": np.ones(2, np.float32)})
        with np.load(path) as data:
            names = set(data.files)
        # dict pytrees flatten in sorted key order: r → leaf_0000, z → leaf_0001
        assert "leaf_0001_re" in names and "leaf_0001_im" in names
        assert "leaf_0001" not in names
        loaded = checkpoint.load_state(
            path, {"z": np.zeros((2, 3), np.complex128),
                   "r": np.zeros(2, np.float32)})
        np.testing.assert_array_equal(np.asarray(loaded["z"]), z)


class TestMetrics:
    def test_jsonl_sink_and_trace(self):
        buf = io.StringIO()
        sink = metrics.MetricsSink(buf)
        sink.write({"x": np.float32(1.5), "y": np.int32(2)})
        A_h, b_h = gen.well_conditioned_system(16, seed=1)
        s = maus_tpu.MausSolver(A_h, ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=b_h, initial_num_candidates=4)
        rep = s.evolve(max_iterations=5, collect_metrics=True)
        _, m = ev.evolve_scan(s.config, s.knowledge, s.A, s.b, s._key, 5, 1)
        n = sink.write_trace(m, prefix={"run": "t"})
        lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        assert lines[0] == {"x": 1.5, "y": 2}
        assert n == 5 and len(lines) == 6
        assert "landscape_energy" in lines[1] and lines[1]["run"] == "t"


class TestTruth:
    def test_eig_truth_comparison(self):
        A = gen.laplace_like_complex(8, make_hermitian=True)
        rep = maus_tpu.eig(A, tol=1e-7, max_iterations=50, num_candidates=30)
        t = truth.compare(rep, A)
        assert t.matched == 8 and t.max_abs_error < 1e-6

    def test_linear_truth_comparison(self):
        A, b = gen.well_conditioned_system(32, seed=2)
        rep = maus_tpu.solve(A, b, max_iterations=40, num_candidates=8)
        t = truth.compare(rep, A, b)
        assert t.matched >= 1 and t.max_abs_error < 1e-8

    def test_svd_truth_values(self):
        A = gen.low_rank_svd_matrix(6, 5, target_rank=2, seed=1)
        s = truth.compute_truth(A, ProblemType.SVD)
        np.testing.assert_allclose(s[:2], [5.0, 2.5], rtol=1e-3)


class TestCLI:
    def test_solve_command(self, capsys):
        from maus_tpu.cli import main
        rc = main(["solve", "--n", "16", "--iters", "30", "--cands", "6",
                   "--check"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "distinct solutions" in out and "vs LAPACK truth" in out

    def test_age_command_json(self, capsys):
        from maus_tpu.cli import main
        rc = main(["age", "--cycles", "1", "--cands", "4", "--json"])
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0
        rec = json.loads(out[-1])
        assert rec["cycle"] == 1 and "best_fitness" in rec


class TestSolverCheckpointAPI:
    def test_evolve_checkpoint_and_resume(self, tmp_path):
        import maus_tpu as mt
        A, b = gen.well_conditioned_system(24, seed=5)
        path = str(tmp_path / "run.npz")
        s1 = mt.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                           initial_num_candidates=6)
        r1 = s1.evolve(max_iterations=2, checkpoint_path=path)
        s2 = mt.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                           initial_num_candidates=6)
        r2 = s2.evolve(max_iterations=40, resume_from=path)
        assert r2.converged
        # resumed run's iteration counter continues from the checkpoint
        assert r2.iterations > 2


class TestXfer:
    def test_complex_roundtrip(self):
        from maus_tpu.utils import xfer
        rng = np.random.default_rng(0)
        z = (rng.standard_normal((5, 7)) + 1j * rng.standard_normal((5, 7)))
        d = xfer.to_device_complex(z, np.complex128)
        back = xfer.to_host_complex(d)
        np.testing.assert_allclose(back, z, rtol=1e-12)

    def test_real_passthrough(self):
        from maus_tpu.utils import xfer
        x = np.arange(4.0)
        d = xfer.to_device_complex(x, np.float64)
        np.testing.assert_array_equal(xfer.to_host_complex(d), x)


class TestCandidateHistory:
    def test_capture_history_flag(self):
        import dataclasses
        import maus_tpu as mt
        A, b = gen.well_conditioned_system(16, seed=0)
        cfg = mt.SolverConfig(num_candidates=6, capture_history=True,
                              dtype=np.complex128)
        s = mt.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                          config=cfg)
        rep = s.evolve(max_iterations=8, collect_metrics=True)
        assert rep.metrics["candidate_residuals"].shape == (8, 6)
        assert rep.metrics["candidate_status"].shape == (8, 6)
        # without the flag the placeholders are zero-size
        s2 = mt.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                          initial_num_candidates=6)
        rep2 = s2.evolve(max_iterations=8, collect_metrics=True)
        assert rep2.metrics["candidate_residuals"].shape == (8, 0)


class TestCLIMore:
    def test_eig_command_hermitian_check(self, capsys):
        from maus_tpu.cli import main
        rc = main(["eig", "--n", "8", "--hermitian", "--tol", "1e-6",
                   "--cands", "16", "--check"])
        out = capsys.readouterr().out
        assert rc == 0 and "matched" in out

    def test_svd_command(self, capsys):
        from maus_tpu.cli import main
        rc = main(["svd", "--rows", "6", "--cols", "4", "--rank", "2",
                   "--tol", "1e-5", "--iters", "60", "--cands", "10"])
        out = capsys.readouterr().out
        assert rc == 0 and "σ =" in out


class TestRefineChunkSizing:
    """_refine_chunk bounds the spectral-refinement batch by its
    factorization workspace (a share of device memory in CH·N² shifted
    systems; halved in the branch-memory-cap QR regime where Q and R double
    per-candidate storage). Under such a cap
    refine_eig._percand_shifted_solver switches transport (vmap LU →
    lax.map LU → lax.map QR) instead of chunking."""

    # device memory at which the workspace share is 2 GiB
    _MEM = int((2 << 30) / maus_tpu.MausSolver._REFINE_CHUNK_SHARE) + 1

    def _solver_with_shape(self, n, monkeypatch):
        from maus_tpu.core import backend
        monkeypatch.setattr(backend, "device_memory_bytes",
                            lambda: self._MEM)
        A, b = gen.well_conditioned_system(16, seed=0)
        s = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=b, initial_num_candidates=4)
        import dataclasses
        s.knowledge = dataclasses.replace(s.knowledge, shape=(n, n))
        return s

    @pytest.mark.parametrize("n,expect", [(2048, 8), (4096, 8),
                                          (8192, 2), (16384, 1)])
    def test_workspace_rule(self, n, expect, monkeypatch):
        # CPU x64 → c128 factors (itemsize 16); c64 doubles these
        s = self._solver_with_shape(n, monkeypatch)
        assert s._refine_chunk() == expect

    def test_qr_regime_halves_budget(self, monkeypatch):
        from maus_tpu.core import backend
        s = self._solver_with_shape(8192, monkeypatch)
        base = s._refine_chunk()             # no cap: full 2 GiB budget
        monkeypatch.setattr(backend, "branch_memory_cap", lambda: True)
        assert s._refine_chunk() == max(base // 2, 1)   # QR regime: halved

    def test_percand_solver_regimes(self, monkeypatch):
        """Transport selection under a branch memory cap: vmap LU at small N,
        lax.map LU to 4096, lax.map QR above — pinned via a counting lax.map
        stub."""
        import jax

        from maus_tpu.core import backend
        from maus_tpu.ops import refine_eig as re_mod
        calls = []

        real_map = jax.lax.map

        def fake_map(f, xs):
            calls.append("map")
            return real_map(f, xs)
        monkeypatch.setattr(backend, "branch_memory_cap", lambda: True)
        monkeypatch.setattr(re_mod.jax.lax, "map", fake_map)
        rng = np.random.default_rng(0)
        H = rng.standard_normal((8, 8)) + 8 * np.eye(8)

        import jax.numpy as jnp
        build_H = lambda s: jnp.asarray(H) + s * jnp.eye(8)
        shifts = jnp.arange(3.0)

        re_mod._percand_shifted_solver(build_H, shifts, 2048)
        assert calls == []                   # vmap LU regime
        re_mod._percand_shifted_solver(build_H, shifts, 4096)
        assert calls == ["map"]              # lax.map LU regime
        calls.clear()
        solve = re_mod._percand_shifted_solver(build_H, shifts, 8192)
        assert calls == ["map"]              # lax.map QR regime
        # QR-regime solves match direct solves of the shifted systems
        B = jnp.asarray(rng.standard_normal((3, 8)))
        X = np.asarray(solve(B))
        for k in range(3):
            ref = np.linalg.solve(H + float(shifts[k]) * np.eye(8),
                                  np.asarray(B[k]))
            np.testing.assert_allclose(X[k], ref, rtol=1e-10)

    def test_percand_map_lu_matches_vmap(self):
        """The lax.map LU route must produce identical factors (same inner
        computation, only the batching transport differs)."""
        import jax
        import jax.numpy as jnp
        import jax.scipy.linalg as jsla

        rng = np.random.default_rng(0)
        A = jnp.asarray(rng.standard_normal((3, 16, 16)))

        lu_v, piv_v = jax.vmap(jsla.lu_factor)(A)
        lu_m, piv_m = jax.lax.map(jsla.lu_factor, A)
        np.testing.assert_array_equal(np.asarray(lu_v), np.asarray(lu_m))
        np.testing.assert_array_equal(np.asarray(piv_v), np.asarray(piv_m))
