"""Exact-slicing (Ozaki-scheme) residual: the f64 residual from bf16 slice
GEMMs for a backend without native f64 (ops/refine.py::SlicedMatrix).

Correctness contract: r = b − A x computed through bf16 slice GEMMs must match
the f64 oracle to f64-ADDITION roundoff (the scheme's products and in-GEMM
accumulations are exact by construction), across scale extremes and operand
shapes. These tests drive the slicing machinery directly on the CPU backend;
no supported platform dispatches to it (ROADMAP D2).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from maus_tpu.ops.refine import (SplitComplex, _slice_array, _sliced_residual,
                                 slice_split_matrix)


def _sc(z):
    return SplitComplex(jnp.asarray(z.real, jnp.float64),
                        jnp.asarray(z.imag, jnp.float64))


def _residual(A, x, b, mant_bits=53):
    sp = jax.jit(lambda a: slice_split_matrix(a, mant_bits=mant_bits))(_sc(A))
    r = jax.jit(_sliced_residual)(sp, _sc(x), _sc(b))
    return np.asarray(r.re) + 1j * np.asarray(r.im)


@pytest.mark.parametrize("ascale,xscale", [(1.0, 1.0), (1e-3, 1e6),
                                           (37.2, 1e-4), (1e8, 1e-8)])
def test_matches_f64_oracle(ascale, xscale):
    rng = np.random.default_rng(0)
    n = 192
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) * ascale
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * xscale
    b = A @ x * (1 + 1e-13)          # near-cancelling residual
    r = _residual(A, x, b)
    r_ref = b - A @ x
    denom = np.linalg.norm(A) * np.linalg.norm(x)
    assert np.linalg.norm(r - r_ref) / denom < 1e-15


def test_slice_reconstruction_exact():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(257) * np.exp(rng.uniform(-20, 20, 257))
    sl, sigma = jax.jit(lambda p: _slice_array(p, 12, 5))(
        jnp.asarray(v, jnp.float64))
    w = 5
    recon = np.zeros_like(v)
    for k in range(12):
        recon += np.asarray(sl[k], np.float64) * 2.0 ** (-w * (k + 1))
    recon *= float(sigma)
    # 12 slices × 5 bits = 60 ≥ 52: reconstruction is exact up to entries more
    # than 2^-60 below the global max (absolute truncation grid)
    assert np.max(np.abs(recon - v)) <= float(sigma) * 2.0 ** -60


def test_extract_ladder_f32_tail_bound():
    """The f32 tail (the default where f64 is not native): after two wide f64
    passes the remainder is cast to f32, adding ≤ 2^-55·σ absolute error —
    below the ladder's 2^-53·σ truncation contract. The first 30 bits (slices
    0-5) must be bit-identical to the exact extraction."""
    from maus_tpu.ops.refine import _pow2_ceil, extract_ladder
    rng = np.random.default_rng(7)
    n = 96
    re = rng.standard_normal((n, n)) * np.exp(rng.uniform(-20, 20, (n, n)))
    im = rng.standard_normal((n, n)) * np.exp(rng.uniform(-20, 20, (n, n)))
    rej, imj = jnp.asarray(re, jnp.float64), jnp.asarray(im, jnp.float64)
    sigma = _pow2_ceil(jnp.maximum(jnp.max(jnp.abs(rej)),
                                   jnp.max(jnp.abs(imj))))
    exact = jax.jit(lambda r, i, s: extract_ladder(r, i, s, f32_tail=False))(
        rej, imj, sigma)
    tail = jax.jit(lambda r, i, s: extract_ladder(r, i, s, f32_tail=True))(
        rej, imj, sigma)
    w, sig = 5, float(sigma)

    def recon(sl):
        out = np.zeros((n, n))
        for k in range(sl.shape[0]):
            out += np.asarray(sl[k], np.float64) * 2.0 ** (-w * (k + 1))
        return out * sig

    for sl_e, sl_t, plane in ((exact[0], tail[0], re), (exact[1], tail[1],
                                                        im)):
        assert np.max(np.abs(recon(sl_e) - plane)) <= sig * 2.0 ** -60
        assert np.max(np.abs(recon(sl_t) - plane)) <= sig * 2.0 ** -54
        # handoff happens strictly below the first 30 bits
        np.testing.assert_array_equal(np.asarray(sl_e[:6], np.float32),
                                      np.asarray(sl_t[:6], np.float32))


def test_slices_are_bf16_integers():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    sp = jax.jit(slice_split_matrix)(_sc(A))
    assert sp.sl_re.dtype == jnp.bfloat16
    s = np.asarray(sp.sl_re, np.float32)
    assert np.all(s == np.round(s))
    assert np.max(np.abs(s)) <= 32          # |slice| ≤ 2^w, w = 5


def test_zero_and_real_operands():
    n = 32
    A = np.zeros((n, n), complex)
    x = np.ones(n) + 0j
    b = np.ones(n) + 0j
    assert np.allclose(_residual(A, x, b), b)
    # purely real A (zero imag plane shares the joint scale)
    rng = np.random.default_rng(3)
    Ar = rng.standard_normal((n, n)) + 0j
    xr = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    br = Ar @ xr
    r = _residual(Ar, xr, br)
    assert np.linalg.norm(r) / (np.linalg.norm(Ar) * np.linalg.norm(xr)) < 1e-15


def test_refine_split_cpu_path_unchanged():
    # on the CPU backend refine_split uses the native-f64 3M path; this guards
    # the dispatch plumbing around the new static a_mant_bits argument
    from maus_tpu.ops.batched_solve import shared_factor_qr
    from maus_tpu.ops.refine import refine_split

    rng = np.random.default_rng(4)
    n = 96
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) \
        + n * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    dt = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
    Aj = jnp.asarray(A, dt)
    fac = shared_factor_qr(Aj, 0.0)
    x0 = jnp.asarray(np.linalg.solve(A, b) * (1 + 1e-4), dt)
    xs, rel = refine_split(Aj, fac, jnp.asarray(b, dt), x0, steps=20,
                           tol=1e-12)
    assert float(rel) < 1e-12


def test_sliced_matvec_batch_matches_oracle():
    from maus_tpu.ops.refine import sliced_matvec_batch

    rng = np.random.default_rng(5)
    M, N, K = 96, 160, 7
    A = rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))
    # rows with wildly different magnitudes exercise the per-row scales
    X = (rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))) \
        * np.logspace(-6, 6, K)[:, None]
    sp = jax.jit(slice_split_matrix)(_sc(A))
    Y = jax.jit(sliced_matvec_batch, static_argnames=("adjoint",))(sp, _sc(X))
    got = np.asarray(Y.re) + 1j * np.asarray(Y.im)
    ref = X @ A.T                     # rows are A @ x_k
    denom = np.linalg.norm(A) * np.abs(X).max(axis=1) + 1e-300
    assert np.max(np.abs(got - ref).max(axis=1) / denom) < 1e-15

    Xm = (rng.standard_normal((K, M)) + 1j * rng.standard_normal((K, M)))
    Ya = jax.jit(sliced_matvec_batch, static_argnames=("adjoint",))(
        sp, _sc(Xm), adjoint=True)
    got_a = np.asarray(Ya.re) + 1j * np.asarray(Ya.im)
    ref_a = Xm @ np.conj(A)           # rows are Aᴴ @ x_k
    denom_a = np.linalg.norm(A) * np.abs(Xm).max(axis=1) + 1e-300
    assert np.max(np.abs(got_a - ref_a).max(axis=1) / denom_a) < 1e-15


class TestDistSlicedResidual:
    """Column-sharded exact-slicing residual (VERDICT r2 #3): per-shard bf16
    ladders under a pmax-shared global scale must reproduce the DENSE sliced
    residual bit-for-bit in f64, and the sliced refine_distributed path must
    reach the same tolerance as the GSPMD-f64 one."""

    @pytest.fixture(scope="class")
    def mesh(self):
        from jax.sharding import Mesh
        return Mesh(np.array(jax.devices()).reshape(-1), ("model",))

    def test_identical_to_dense_sliced(self, mesh):
        from maus_tpu.parallel.dist_refine import (dist_slice_operand,
                                                   dist_sliced_residual)
        rng = np.random.default_rng(0)
        n = 64
        A = (rng.standard_normal((n, n)) * np.exp(
            rng.uniform(-8, 8, (n, n)))) + 1j * rng.standard_normal((n, n))
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = A @ x + 1e-7 * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
        dense = _residual(A, x, b)
        sl_re, sl_im, sigma = dist_slice_operand(mesh, _sc(A))
        r = dist_sliced_residual(mesh, sl_re, sl_im, sigma, _sc(x), _sc(b))
        dist = np.asarray(r.re) + 1j * np.asarray(r.im)
        # identical ladder + identical exact products; the only difference is
        # f64 summation order across shards -> f64-addition roundoff
        scale = np.linalg.norm(A) * np.linalg.norm(x)
        assert np.max(np.abs(dist - dense)) < 1e-14 * scale
        exact = b - A @ x
        assert np.max(np.abs(dist - exact)) < 1e-12 * scale

    def test_refine_distributed_sliced_path(self, mesh):
        """Force sliced=True on the CPU mesh: the wiring must converge to the
        same tolerance as the default GSPMD-f64 residual path."""
        from maus_tpu.parallel.dist_qr import (dist_qr, dist_qr_solve,
                                               refine_distributed,
                                               stage_operands)
        rng = np.random.default_rng(1)
        n = 16 * len(jax.devices())
        A = rng.standard_normal((n, n)) + \
            1j * rng.standard_normal((n, n)) + n * np.eye(n)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        A_dev, b_dev, Are, Aim, bre, bim = stage_operands(mesh, A, b)
        # force the c64 factorization so refinement has real work to do
        A_c64 = jax.jit(lambda a: a.astype(jnp.complex64))(A_dev)
        b_c64 = jax.jit(lambda v: v.astype(jnp.complex64))(b_dev)
        block = 16
        fac = dist_qr(mesh, A_c64, block=block)
        x0 = dist_qr_solve(mesh, fac, b_c64, block=block)
        xre, xim, rel = refine_distributed(
            mesh, fac, Are, Aim, bre, bim, x0, block, 20, 1e-12, sliced=True)
        x = np.asarray(xre) + 1j * np.asarray(xim)
        resid = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert float(rel) < 1e-12
        assert resid < 1e-12


class TestStreamedSlicedResidual:
    """Panel-streamed slice residual (VERDICT r2 #4): identical ladder, only
    f64 accumulation order differs from the resident-ladder version."""

    def test_matches_resident_ladder(self):
        from maus_tpu.ops.refine import _sliced_residual_streamed
        rng = np.random.default_rng(2)
        m, n = 48, 96
        A = (rng.standard_normal((m, n)) * np.exp(
            rng.uniform(-6, 6, (m, n)))) + 1j * rng.standard_normal((m, n))
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = A @ x + 1e-6 * (rng.standard_normal(m)
                            + 1j * rng.standard_normal(m))
        sp = jax.jit(slice_split_matrix)(_sc(A))
        dense = jax.jit(_sliced_residual)(sp, _sc(x), _sc(b))
        dense = np.asarray(dense.re) + 1j * np.asarray(dense.im)
        from maus_tpu.ops.refine import _pow2_ceil
        sigma = _pow2_ceil(max(np.max(np.abs(A.real)), np.max(np.abs(A.imag))))
        for panels in (2, 4, 8):
            r = jax.jit(_sliced_residual_streamed,
                        static_argnames=("panels",))(
                _sc(A), _sc(x), _sc(b), panels=panels)
            streamed = np.asarray(r.re) + 1j * np.asarray(r.im)
            scale = np.linalg.norm(A) * np.linalg.norm(x)
            assert np.max(np.abs(streamed - dense)) < 1e-14 * scale
            # refinement hoists sigma out of the per-call closure — must be
            # bit-identical to the self-computed scale
            r2 = jax.jit(_sliced_residual_streamed,
                         static_argnames=("panels",))(
                _sc(A), _sc(x), _sc(b), panels=panels, sigma=sigma)
            assert np.array_equal(np.asarray(r2.re), np.asarray(r.re))
            assert np.array_equal(np.asarray(r2.im), np.asarray(r.im))
        exact = b - A @ x
        assert np.max(np.abs(streamed - exact)) < 1e-12 * scale

    def test_panel_count_picker(self):
        from maus_tpu.ops.refine import streamed_panels
        import jax.numpy as jnp
        from maus_tpu.ops.refine import SplitComplex
        # ShapeDtypeStruct: streamed_panels only reads .size/.shape, no need
        # to allocate 2 GB of zeros in a unit test
        z = jax.ShapeDtypeStruct((16384, 16384), jnp.float64)
        sp = SplitComplex(z, z)
        p = streamed_panels(sp)
        assert 24 * 2 * z.size / p <= 3e9
        # prime N must NOT degenerate (the old smallest-divisor search gave
        # p = N one-column panels for prime column counts)
        zp = jax.ShapeDtypeStruct((11213, 11213), jnp.float64)
        pp = streamed_panels(SplitComplex(zp, zp))
        assert pp <= 8
        assert 24 * 2 * zp.size / pp <= 3e9 * 1.25   # ceil panel ≤ 25% over

    def test_streamed_residual_nondivisible_panels(self):
        """The unrolled panel loop handles panel counts that do not divide
        the column count (remainder panel) exactly."""
        from maus_tpu.ops.refine import (_sliced_residual_streamed,
                                         _pow2_ceil)
        rng = np.random.default_rng(12)
        m, n = 96, 67                                 # prime column count
        A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = A @ x * (1 + 1e-13)
        for panels in (1, 2, 3, 5):
            r = jax.jit(lambda a, xx, bb: _sliced_residual_streamed(
                a, xx, bb, panels))(_sc(A), _sc(x), _sc(b))
            rf = np.asarray(r.re) + 1j * np.asarray(r.im)
            r_ref = b - A @ x
            scale = np.linalg.norm(A) * np.linalg.norm(x)
            assert np.max(np.abs(rf - r_ref)) < 1e-15 * scale, panels


class TestC64ExactRefine:
    """refine_split_c64exact: refinement of a c64-exact operand, with the f64
    planes widened inside the program and A itself as the matvec copy."""

    def test_refine_split_c64exact_cpu_fallback(self):
        """The c64-exact entry refines through the widened-plane native-f64
        residual to f64 accuracy."""
        from maus_tpu.ops.batched_solve import factor_qr
        from maus_tpu.ops.refine import refine_split_c64exact
        rng = np.random.default_rng(7)
        n = 128
        Ac = ((rng.standard_normal((n, n))
               + 1j * rng.standard_normal((n, n))) / np.sqrt(n)).astype(
                   np.complex64)
        x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = Ac.astype(np.complex128) @ x_true
        fac = factor_qr(jnp.asarray(Ac))
        x0 = jnp.linalg.solve(jnp.asarray(Ac), jnp.asarray(
            b.astype(np.complex64)))
        xs, rel = refine_split_c64exact(jnp.asarray(Ac), fac, _sc(b), x0,
                                        steps=20, tol=1e-13)
        assert float(rel) < 1e-12

    def test_refine_with_fac_planes_matches_complex(self):
        """FacPlanes (f32/f64 plane pairs recombined inside the jit) is an
        accepted form of the factors. The planes path must be numerically
        IDENTICAL: the lax.complex recombination folds, it does not round."""
        from maus_tpu.ops.batched_solve import factor_qr
        from maus_tpu.ops.refine import fac_to_planes, refine_split_c64exact
        rng = np.random.default_rng(11)
        n = 96
        Ac = ((rng.standard_normal((n, n))
               + 1j * rng.standard_normal((n, n))) / np.sqrt(n)).astype(
                   np.complex64)
        x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = Ac.astype(np.complex128) @ x_true
        fac = factor_qr(jnp.asarray(Ac))
        x0 = jnp.linalg.solve(jnp.asarray(Ac),
                              jnp.asarray(b.astype(np.complex64)))
        xs_c, rel_c = refine_split_c64exact(jnp.asarray(Ac), fac, _sc(b), x0,
                                            steps=20, tol=1e-13)
        facp = fac_to_planes(fac)
        xs_p, rel_p = refine_split_c64exact(jnp.asarray(Ac), facp, _sc(b),
                                            x0, steps=20, tol=1e-13)
        assert float(rel_p) < 1e-12
        np.testing.assert_array_equal(np.asarray(xs_c.re), np.asarray(xs_p.re))
        np.testing.assert_array_equal(np.asarray(xs_c.im), np.asarray(xs_p.im))
        assert float(rel_c) == float(rel_p)
