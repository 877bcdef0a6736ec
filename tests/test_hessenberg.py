"""Hessenberg reduction + batched shifted solves (ops/hessenberg.py) — the
O(N²)-per-shift replacement for the eig path's batched LU."""
import numpy as np

import jax.numpy as jnp

from maus_tpu.ops.hessenberg import (reduce_hessenberg,
                                     solve_shifted_hessenberg,
                                     solve_shifted_via_hessenberg)


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))


class TestReduction:
    def test_similarity_and_structure(self):
        A = _rand(64)
        cache = reduce_hessenberg(jnp.asarray(A, jnp.complex128))
        H = np.asarray(cache.h)
        Q = np.asarray(cache.q)
        assert np.linalg.norm(Q @ H @ Q.conj().T - A) < 1e-12 * np.linalg.norm(A)
        assert np.linalg.norm(Q.conj().T @ Q - np.eye(64)) < 1e-12
        assert np.abs(np.tril(H, -2)).max() == 0.0

    def test_c64_accuracy(self):
        A = _rand(96, seed=1)
        cache = reduce_hessenberg(jnp.asarray(A, jnp.complex64))
        H = np.asarray(cache.h, np.complex128)
        Q = np.asarray(cache.q, np.complex128)
        rel = np.linalg.norm(Q @ H @ Q.conj().T - A) / np.linalg.norm(A)
        assert rel < 5e-6


class TestShiftedSolve:
    def test_matches_dense_solve(self):
        n, k = 80, 6
        A = _rand(n, seed=2)
        rng = np.random.default_rng(3)
        lams = rng.standard_normal(k) + 1j * rng.standard_normal(k)
        B = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
        cache = reduce_hessenberg(jnp.asarray(A, jnp.complex128))
        W = np.asarray(solve_shifted_via_hessenberg(
            cache, jnp.asarray(lams), jnp.asarray(B)))
        for lam, w, b in zip(lams, W, B):
            r = np.linalg.norm((A - lam * np.eye(n)) @ w - b) / np.linalg.norm(b)
            assert r < 1e-11

    def test_psi_regularization_applied(self):
        """ψ shifts the diagonal: the solve then targets (H − λI + ψI)."""
        n, k = 32, 3
        A = _rand(n, seed=4)
        cache = reduce_hessenberg(jnp.asarray(A, jnp.complex128))
        H = np.asarray(cache.h)
        lams = np.zeros(k, complex)
        psi = np.array([1e-3, 1e-2, 1e-1])
        B = np.ones((k, n), complex)
        W = np.asarray(solve_shifted_hessenberg(
            jnp.asarray(H), jnp.asarray(lams), jnp.asarray(B),
            jnp.asarray(psi)))
        for p, w, b in zip(psi, W, B):
            r = np.linalg.norm((H + p * np.eye(n)) @ w - b) / np.linalg.norm(b)
            assert r < 1e-11

    def test_near_singular_shift_stays_finite(self):
        """Givens QR needs no pivoting: a shift AT an eigenvalue still returns
        a finite (huge-norm) inverse-iteration direction, which is exactly
        what RQI consumes."""
        n = 48
        A = _rand(n, seed=5)
        w_true = np.linalg.eigvals(A)
        cache = reduce_hessenberg(jnp.asarray(A, jnp.complex128))
        lams = jnp.asarray(np.array([w_true[0] + 1e-12]), jnp.complex128)
        B = jnp.asarray(np.ones((1, n), complex))
        W = np.asarray(solve_shifted_via_hessenberg(cache, lams, B))
        assert np.all(np.isfinite(W.real)) and np.all(np.isfinite(W.imag))
        assert np.linalg.norm(W) > 1e6    # amplifies the eigendirection


class TestBlockedReduction:
    """Compact-WY panel reduction (reduce_hessenberg_blocked) — the large-N
    upgrade of the per-column scan."""

    def _check(self, n, nb, tol=1e-12):
        from maus_tpu.ops.hessenberg import reduce_hessenberg_blocked

        A = _rand(n, seed=n)
        cache = reduce_hessenberg_blocked(jnp.asarray(A, jnp.complex128),
                                          nb=nb)
        H = np.asarray(cache.h)
        Q = np.asarray(cache.q)
        assert np.linalg.norm(Q @ H @ Q.conj().T - A) < tol * np.linalg.norm(A)
        assert np.linalg.norm(Q.conj().T @ Q - np.eye(n)) < tol * n
        assert np.abs(np.tril(H, -2)).max() == 0.0

    def test_exact_panels(self):
        self._check(130, 64)          # (N−2) = 2 panels exactly

    def test_remainder_tail(self):
        self._check(150, 64)          # 2 panels + 20 single-step tail

    def test_small_panel(self):
        self._check(96, 32)

    def test_matches_scan_version_eigenvalues(self):
        from maus_tpu.ops.hessenberg import reduce_hessenberg_blocked

        A = _rand(72, seed=9)
        blocked = reduce_hessenberg_blocked(jnp.asarray(A, jnp.complex128),
                                            nb=32)
        # eigenvalues are similarity invariants — both reductions must agree
        ev_b = np.sort_complex(np.linalg.eigvals(np.asarray(blocked.h)))
        ev_a = np.sort_complex(np.linalg.eigvals(A))
        assert np.max(np.abs(ev_b - ev_a)) < 1e-10

    def test_auto_dispatch(self):
        from maus_tpu.ops.hessenberg import reduce_hessenberg_auto

        for n in (40, 200):           # below / above the blocked threshold
            A = _rand(n, seed=n)
            cache = reduce_hessenberg_auto(jnp.asarray(A, jnp.complex128))
            H = np.asarray(cache.h)
            Q = np.asarray(cache.q)
            rel = np.linalg.norm(Q @ H @ Q.conj().T - A) / np.linalg.norm(A)
            assert rel < 1e-12
            assert np.abs(np.tril(H, -2)).max() == 0.0


class TestCandidateChunking:
    def test_chunked_matches_single_batch(self, monkeypatch):
        """Past the single-batch temp cap (_hess_solve_budgets) the sweep
        runs candidate-chunked under lax.map (the single-batch scan carries
        2·K·N² of temps — 34 GiB at the 8192²/K=32 eig config). The
        chunked result must be BIT-identical: same scan body, same order,
        only the batching changes. Covers uneven K (pad duplicates the last
        candidate, then slices off) and the psi operand."""
        import maus_tpu.ops.hessenberg as hz
        rng = np.random.default_rng(5)
        n, K = 48, 7
        A = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))).astype(np.complex64)
        cache = hz.reduce_hessenberg(jnp.asarray(A))
        lams = jnp.asarray((rng.standard_normal(K)
                            + 1j * rng.standard_normal(K)).astype(np.complex64))
        B = jnp.asarray((rng.standard_normal((K, n))
                         + 1j * rng.standard_normal((K, n))).astype(np.complex64))
        psi = jnp.asarray(np.full(K, 1e-4, np.float32))
        x_ref = np.asarray(solve_shifted_via_hessenberg(cache, lams, B, psi))
        monkeypatch.setattr(hz, "_hess_solve_budgets",
                            lambda: (1, 3 * 2 * n * n * 8))  # kc=3: 7 pads to 9
        hz.solve_shifted_hessenberg._clear_cache()
        x_chunk = np.asarray(solve_shifted_via_hessenberg(cache, lams, B, psi))
        hz.solve_shifted_hessenberg._clear_cache()
        np.testing.assert_array_equal(x_ref, x_chunk)
